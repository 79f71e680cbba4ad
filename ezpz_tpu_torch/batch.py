"""Scenario batching: solve many same-topology sketches at once.

The PyTorch counterpart of ``ezpz_tpu/batch.py``. One topology, a batch
of initial guesses and per-sketch constraint parameters, each sketch
running its own Levenberg-Marquardt loop. This package has the fused
mixed-precision path only (``precision="mixed"``, ``pallas_fused=True``,
``batch_params=True``): on a CUDA tensor it runs the hand-written kernel of
``ops/fused_fleet``, on a CPU tensor the kernel's plain version. The
batched f64 and mixed XLA-style paths, the coarse kernel and
``finish_stragglers`` are ROADMAP queue-1 items 4-6 and queue-2 item 1;
asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .config import Config
from .models.compiled import CompiledSystem
from .ops.fleet_plan import plan_fleet
from .ops.fused_fleet import fused_fleet_solve

_ONLY_FUSED = (
    "ezpz_tpu_torch.BatchSolver supports only batch_params=True, "
    "precision='mixed', pallas_fused=True so far; the batched f64/mixed "
    "paths and the coarse kernel are ROADMAP.md queue 1 items 4-6 and "
    "queue 2 item 1"
)


@dataclass
class BatchResult:
    x: torch.Tensor  # (B, n_vars) float64
    iterations: torch.Tensor  # (B,) int32
    converged: torch.Tensor  # (B,) bool
    satisfied: torch.Tensor  # (B, n_constraints) bool
    degenerate: torch.Tensor  # (B, n_constraints) bool


class BatchSolver:
    """A fused mixed-precision fleet solver for one topology.

    ``pars`` is a tuple of (B, n_k, np_k) float64 tensors aligned with
    ``system.blocks`` — per-sketch constraint parameters. The constructor
    takes the JAX package's argument names; ``pallas_trips`` is the coarse
    (f32) trip count and ``refine_trips`` the f64-residual trip count.

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
    ...                      precision="mixed", pallas_fused=True)
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
                 pallas_fused: bool = False, refine_trips: int = 4):
        if not (batch_params and precision == "mixed" and pallas_fused):
            raise NotImplementedError(_ONLY_FUSED)
        self.system = system
        self.config = config
        self.batch_params = batch_params
        self.precision = precision
        self.pallas_coarse = True  # phase 1 of the fused kernel
        self.pallas_fused = pallas_fused
        self.pallas_trips = pallas_trips
        self.refine_trips = refine_trips
        self.plan = plan_fleet(system)

    def settings(self) -> dict:
        """The fused solver's trip counts and tolerances (as the JAX
        package's ``_pallas_fused_fn`` passes them)."""
        c = self.config
        return dict(
            coarse_trips=min(self.pallas_trips, c.max_iterations),
            refine_trips=self.refine_trips,
            max_iterations=c.max_iterations,
            # O(1)-coordinate coarse tolerance, scaled per lane in the
            # kernel by max(1, |x0|_inf), with a 1e-7*scale step floor.
            coarse_tolerance=5e-6,
            residual_tolerance=c.residual_tolerance,
            coarse_step_tolerance=c.step_tolerance,
            step_tolerance=c.step_tolerance,
            initial_lambda=c.initial_lambda,
        )

    def solve(self, x0: torch.Tensor, pars: Optional[Tuple] = None,
              finish_stragglers: bool = False) -> BatchResult:
        """Solve the batch on ``x0``'s device. ``finish_stragglers`` is not
        supported yet (ROADMAP.md queue 1 item 6)."""
        if finish_stragglers:
            raise NotImplementedError(
                "finish_stragglers needs the batched mixed path "
                "(ROADMAP.md queue 1 item 6)")
        if pars is None:
            raise ValueError("batch_params=True requires pars")
        x0 = torch.as_tensor(x0, dtype=torch.float64)
        pars = tuple(torch.as_tensor(p, dtype=torch.float64, device=x0.device)
                     for p in pars)
        x, its, conv, sat, deg = fused_fleet_solve(self.plan, x0, pars,
                                                   **self.settings())
        return BatchResult(x=x, iterations=its, converged=conv,
                           satisfied=sat, degenerate=deg)
