"""Scenario batching: solve many same-topology sketches at once.

The PyTorch counterpart of ``ezpz_tpu/batch.py``. One topology, a batch
of initial guesses and (optionally) per-sketch constraint parameters, each
sketch running its own Levenberg-Marquardt loop. The modes:

* ``precision="f64"`` or ``"mixed"`` with both kernels off: the batched
  LM loop of ``solver`` (``solve_lm``, ``solve_lm_mixed``), for
  ``batch_params`` True or False;
* ``pallas_coarse=True, pallas_fused=False``: the coarse fleet kernel
  (``ops/coarse_fleet``) for a fixed number of f32 trips, then the batched
  f64-residual ``solve_lm_refine``;
* ``pallas_fused=True``: both phases in the fused fleet kernel
  (``ops/fused_fleet``).

``solve_analysis`` adds the batched freedom analysis (``dof``), and
``MultiTopologySolver`` runs several topologies' batches in turn.

The batched LM loops (both plain modes, the coarse path's refinement, and
a kernel mode's topology past the gate) solve their damped normal
equations with the topology's tier, ``_pick_spd``: a topology of more
than 24 variables whose identity or RCM ordering has a narrow band
assembles and factors JtJ in that band (``ops/banded.BandRoute``, the
hand-written banded kernels on the card), any other densely
(``ops/linalg.spd_solve``).

The kernel modes need ``precision="mixed"`` and ``batch_params=True`` (the
JAX package asserts the same). They take a topology only when the kernel
gate admits it (``fleet_plan.kernel_admits``: at most 256 instances, a
planned fill of at most 2080, as the JAX package's
``_pallas_topology_ok``); any other topology is routed, before any launch,
to the batched mixed path, as the JAX package routes it to its XLA path. A
kernel wrapper launches its CUDA kernel on a CUDA tensor and takes its
plain PyTorch version on a CPU tensor; the solver runs on ``device``, the
card unless the caller asks for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import tracing
from .config import Config
from .dof import participation_device, underconstrained_from_participation
from .models.compiled import CompiledSystem
from .ops.banded import BandRoute, plan_band
from .ops.coarse_fleet import coarse_fleet_solve
from .ops.device_cache import to_device
from .ops.fleet_plan import kernel_admits, plan_fleet
from .ops.fused_fleet import fused_fleet_solve
from .ops.linalg import UNROLL_MAX_N, spd_solve
from .solver import (COARSE_TOLERANCE, LMResult, resolve_device, solve_lm,
                     solve_lm_mixed, solve_lm_refine)
from .utils.errors import EmptySystemNotAllowed


def _pick_spd(system: CompiledSystem):
    """The topology's normal-equation solver, by the JAX package's rule
    (``ezpz_tpu/batch.py:89-117``): n <= 24 the unrolled Crout and n > 24
    with no narrow ordering the library's dense factorization (both
    ``spd_solve``); n > 24 with an identity or RCM ordering whose band is
    narrow (``plan_band``: bw <= 32 and bw + 1 < n // 2) the O(n bw^2)
    band tier, a ``BandRoute``: the LM loop then assembles JtJ straight
    into the (B, n, bw+1) band and damps its diagonal there
    (``solver._damped_step``), so no (B, n, n) matrix is written. The JAX
    package's column-sweep tier (24 < n <= 64, no narrow ordering) answers
    XLA's slow TPU Cholesky and is ``spd_solve`` here. The plans (RCM and
    the band's assembly plan, on the host) are made once per topology, in
    ``BatchSolver.__init__``."""
    n = system.n_vars
    if n > UNROLL_MAX_N:
        plan = plan_band(system)
        if plan is not None:
            perm, bw = plan
            return BandRoute(system, perm, bw)
    return spd_solve


@dataclass
class BatchResult:
    x: torch.Tensor  # (B, n_vars) float64
    iterations: torch.Tensor  # (B,) int32
    converged: torch.Tensor  # (B,) bool
    satisfied: torch.Tensor  # (B, n_constraints) bool
    degenerate: torch.Tensor  # (B, n_constraints) bool


class BatchSolver:
    """A batched LM solver for one topology.

    ``pars`` (with ``batch_params=True``) is a tuple of (B, n_k, np_k)
    float64 tensors aligned with ``system.blocks``: per-sketch constraint
    parameters. The constructor takes the JAX package's argument names;
    ``pallas_trips`` is the coarse (f32) trip count of the kernel modes and
    ``refine_trips`` the fused kernel's f64-residual trip count. ``device``
    is where ``solve`` runs: the card (``"cuda"``) by default, the CPU only
    when asked (``device="cpu"``).

    Pin p, hold q at distance 5, and solve three sketches at once:

    >>> import torch
    >>> from ezpz_tpu_torch.constraints import Constraint
    >>> from ezpz_tpu_torch.datatypes import DatumPoint
    >>> from ezpz_tpu_torch.models.compiled import compile_system
    >>> p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    >>> system = compile_system([Constraint.Fixed(0, 0.0),
    ...                          Constraint.Fixed(1, 0.0),
    ...                          Constraint.Distance(p, q, 5.0)], n_vars=4)
    >>> x0 = torch.tensor([[0.0, 0.0, 3.0, 3.9],
    ...                    [0.0, 0.0, 2.9, 4.1],
    ...                    [0.0, 0.0, 4.1, 2.8]], dtype=torch.float64)
    >>> pars = tuple(torch.as_tensor(b.par).expand(3, -1, -1)
    ...              for b in system.blocks)
    >>> solver = BatchSolver(system, Config(), batch_params=True,
    ...                      precision="mixed", pallas_fused=True, device="cpu")
    >>> res = solver.solve(x0, pars)
    >>> bool(res.converged.all())
    True
    >>> bool(torch.allclose(torch.hypot(res.x[:, 2], res.x[:, 3]),
    ...                     torch.tensor(5.0, dtype=torch.float64)))
    True
    """

    def __init__(self, system: CompiledSystem, config: Config = Config(),
                 batch_params: bool = False, precision: str = "f64",
                 pallas_coarse: bool = False, pallas_trips: int = 4,
                 pallas_fused: bool = False, refine_trips: int = 4,
                 device=None):
        if precision not in ("f64", "mixed"):
            raise ValueError(f"precision must be 'f64' or 'mixed', got {precision!r}")
        if pallas_fused:
            pallas_coarse = True  # the fused kernel runs the coarse phase too
        if pallas_coarse and not (precision == "mixed" and batch_params):
            raise ValueError("the kernel modes (pallas_coarse, pallas_fused) "
                             "require precision='mixed' and batch_params=True")
        self.system = system
        self.system32 = system.astype(torch.float32)
        self.config = config
        self.batch_params = batch_params
        self.precision = precision
        self.pallas_coarse = pallas_coarse
        self.pallas_fused = pallas_fused
        self.pallas_trips = pallas_trips
        self.refine_trips = refine_trips
        self.device = torch.device("cuda" if device is None else device)
        # Topology routing: the kernels take what their gate admits.
        self.kernel_ok = pallas_coarse and kernel_admits(system)
        self.plan = plan_fleet(system) if self.kernel_ok else None
        # The normal equations' tier: band or dense.
        self.spd = _pick_spd(system)

    def settings(self, config: Optional[Config] = None) -> dict:
        """The fused solver's trip counts and tolerances (as the JAX
        package's ``_pallas_fused_fn`` passes them), from ``config`` or the
        solver's own."""
        c = config or self.config
        return dict(
            coarse_trips=min(self.pallas_trips, c.max_iterations),
            refine_trips=self.refine_trips,
            max_iterations=c.max_iterations,
            # O(1)-coordinate coarse tolerance, scaled per lane in the
            # kernel by max(1, |x0|_inf), with a 1e-7*scale step floor.
            coarse_tolerance=COARSE_TOLERANCE,
            residual_tolerance=c.residual_tolerance,
            coarse_step_tolerance=c.step_tolerance,
            step_tolerance=c.step_tolerance,
            initial_lambda=c.initial_lambda,
        )

    def coarse_settings(self, config: Optional[Config] = None) -> dict:
        """The coarse kernel's trips and tolerances (as the JAX package's
        ``_pallas_coarse_fn`` passes them), from ``config`` or the solver's
        own."""
        c = config or self.config
        return dict(trips=min(self.pallas_trips, c.max_iterations),
                    tolerance=COARSE_TOLERANCE, step_tolerance=c.step_tolerance,
                    initial_lambda=c.initial_lambda)

    def _inputs(self, x0, pars):
        resolve_device(self.device)
        x0 = to_device(x0, dtype=torch.float64, device=self.device)
        if not self.batch_params:
            return x0, None
        if pars is None:
            raise ValueError("batch_params=True requires pars")
        return x0, tuple(to_device(p, dtype=torch.float64, device=self.device)
                         for p in pars)

    def _result(self, res: LMResult, pars) -> BatchResult:
        sat = self.system.satisfaction(res.x, res.residual, pars)
        return BatchResult(x=res.x, iterations=res.iterations,
                           converged=res.converged, satisfied=sat,
                           degenerate=res.deg)

    def _solve_plain(self, x0, pars, config=None) -> BatchResult:
        c = config or self.config
        args = (c.max_iterations, c.residual_tolerance, c.step_tolerance,
                c.initial_lambda)
        if self.precision == "mixed":
            pars32 = None if pars is None else tuple(p.float() for p in pars)
            res = solve_lm_mixed(self.system, self.system32, x0, *args,
                                 pars64=pars, pars32=pars32, spd=self.spd)
        else:
            res = solve_lm(self.system, x0, *args, pars=pars, spd=self.spd)
        return self._result(res, pars)

    def coarse(self, x0: torch.Tensor, pars: Tuple, config=None):
        """The coarse kernel on a batch: ``(x f32 (B, n), iterations (B,)
        int32, degenerate (B, n_cons) bool)``."""
        x, its, _conv, deg = coarse_fleet_solve(self.plan, x0, pars,
                                                **self.coarse_settings(config))
        return x, its, deg

    def refine(self, x1: torch.Tensor, its: torch.Tensor, deg: torch.Tensor,
               pars: Tuple, config=None) -> BatchResult:
        """The batched f64-residual refinement from a coarse result, with
        its budget of ``solver.REFINE_ITERATIONS`` trips (as the JAX
        package's ``refine_one`` calls ``solve_lm_refine``), then
        satisfaction."""
        c = config or self.config
        res = solve_lm_refine(
            self.system, self.system32, x1, its, deg, c.max_iterations,
            c.residual_tolerance, c.step_tolerance, c.initial_lambda,
            pars64=pars, pars32=tuple(p.float() for p in pars), spd=self.spd)
        return self._result(res, pars)

    def _finish_stragglers(self, result: BatchResult, x0, pars,
                           config=None) -> BatchResult:
        """Re-solve the lanes the fixed-trip kernel left unconverged through
        the plain mixed path (restarting from their original guesses) and
        merge. Costs one converged-mask sync per batch."""
        stragglers = torch.nonzero(~result.converged).squeeze(1)
        if stragglers.numel() == 0:
            return result
        res = self._solve_plain(
            x0[stragglers], None if pars is None else tuple(p[stragglers] for p in pars),
            config)
        merged = {}
        for name in ("x", "iterations", "converged", "satisfied", "degenerate"):
            t = getattr(result, name).clone()
            t[stragglers] = getattr(res, name)
            merged[name] = t
        return BatchResult(**merged)

    def solve(self, x0, pars: Optional[Tuple] = None,
              finish_stragglers: bool = False,
              config: Optional[Config] = None) -> BatchResult:
        """Solve the batch on ``self.device``; ``x0`` (B, n) and ``pars``
        may be numpy arrays or tensors on any device. ``config``, when
        given, takes the place of the solver's own for this call.

        ``finish_stragglers`` (kernel modes only): lanes the fixed-trip
        kernel leaves unconverged are re-solved through the plain mixed path
        and merged. A topology outside the kernel gate takes the batched
        mixed path in the kernel modes too. The call is the span
        ``ezpz.batch.solve`` (``tracing``)."""
        with tracing.span("ezpz.batch.solve"):
            x0, pars = self._inputs(x0, pars)
            if not self.kernel_ok:
                return self._solve_plain(x0, pars, config)
            if self.pallas_fused:
                out = BatchResult(*fused_fleet_solve(self.plan, x0, pars,
                                                     **self.settings(config)))
            else:
                out = self.refine(*self.coarse(x0, pars, config), pars, config)
            if finish_stragglers:
                out = self._finish_stragglers(out, x0, pars, config)
            return out

    def solve_analysis(self, x0, pars: Optional[Tuple] = None):
        """Solve the batch AND run the freedom (DoF) analysis per sketch
        (``ezpz/src/lib.rs:134-144``, ``solver/find_dof.rs:15-104``): the B
        dense Jacobians at the solved points and their nullspace
        participations are computed on ``self.device`` in one batched SVD,
        then copied to the host once.

        Returns ``(BatchResult, [FreedomAnalysis] * B)``."""
        system = self.system
        if min(system.n_rows, system.n_vars) == 0:
            raise EmptySystemNotAllowed()
        x0, pars = self._inputs(x0, pars)
        res = self.solve(x0, pars)
        parts, _null = participation_device(system.jacobian_dense(res.x, pars))
        parts = parts.cpu().numpy()
        return res, [underconstrained_from_participation(p) for p in parts]


class MultiTopologySolver:
    """Several same-config batches of DIFFERENT topologies (the buckets of
    a decomposed sketch, ``models.blocks``), solved one after another on
    one device: one ``BatchSolver`` per topology, with per-sketch
    parameters, in the plain f64 or mixed mode.

    ``solve`` takes equal-length lists of initial-guess batches and
    per-sketch parameter tuples, and returns one ``BatchResult`` each."""

    def __init__(self, systems, config: Config = Config(),
                 precision: str = "f64", device=None):
        self.systems = list(systems)
        self.config = config
        self._solvers = [BatchSolver(s, config, batch_params=True,
                                     precision=precision, device=device)
                         for s in self.systems]

    def solve(self, x0s, parss):
        return [s.solve(x0, pars) for s, x0, pars in zip(self._solvers, x0s, parss)]
