"""The fused mixed-precision fleet solver: CUDA kernel, binding and plain
version.

Replaces ``ezpz_tpu.ops.pallas_fleet.make_fused_fleet_solver``. For every
sketch of a fleet that shares one topology, it runs

* phase 1: ``coarse_trips`` f32 Levenberg-Marquardt trips toward the
  per-lane coarse tolerance ``max(tol, 1e-7 * max(1, |x0|_inf))``;
* phase 2: ``refine_trips`` trips toward the absolute residual tolerance
  with f64 residuals, starting exactly at the coarse point. The step comes
  from the f32 Jacobian at ``(float)x`` against the f32-rounded f64
  residual; accept/reject compares the f64 ``|r|^2``. Each lane's budget is
  ``min(max(max_iterations - coarse_its, 0), refine_trips)``.

Each trip takes Jacobian columns by forward mode, forms JtJ/Jtr, damps the
diagonal by ``max(lambda, 1e-6 * max|diag|)``, factors by Crout on the
planned fill (``fleet_plan``) and accepts a step only if ``|r|^2``
strictly drops. Converged lanes are frozen. Per-constraint degenerate and
satisfaction flags ride along; a NaN residual row is unsatisfied (the JAX
kernel reports it satisfied).

``fused_fleet_solve`` dispatches on the device of ``x0``: a CUDA tensor
launches the kernel of ``csrc/fused_fleet.cu`` or raises; a CPU tensor
takes ``fused_fleet_reference``, the same algorithm in eager torch, whose
phase 1 is ``fleet_common.coarse_phase``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import LM_LAMBDA_DECR, LM_LAMBDA_INCR
from . import _build
from .fleet_common import (Topology, check_admitted, check_inputs, coarse_phase,
                           damped_solve, launch, normal_equations, param_rows,
                           residual_rows, rows_max_abs, rows_sumsq)
from .fleet_plan import FleetPlan

# Kernel launches made by ``fused_fleet_solve`` in this process.
LAUNCHES = 0

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
               torch.Tensor]


def fused_fleet_solve(plan: FleetPlan, x0: torch.Tensor,
                      pars: Sequence[torch.Tensor], *, coarse_trips: int,
                      refine_trips: int, max_iterations: int,
                      coarse_tolerance: float, residual_tolerance: float,
                      coarse_step_tolerance: float, step_tolerance: float,
                      initial_lambda: float) -> Result:
    """Solve a fleet: ``x0`` (B, n) float64, ``pars`` per block
    (B, n_k, p_k) float64, with ``coarse_trips`` f32 and ``refine_trips``
    f64-residual LM trips (at most ``max_iterations`` in all), the coarse
    residual and step tolerances (scaled per lane), the absolute residual
    and step tolerances of the refine phase, and the initial damping.
    Returns ``(x (B, n) float64, iterations (B,) int32, converged (B,)
    bool, satisfied (B, n_cons) bool, degenerate (B, n_cons) bool)``.

    A plan outside the kernel gate (``fleet_plan.kernel_admits``) raises
    ``NotImplementedError`` on any device. Otherwise a CUDA ``x0`` launches
    the hand-written kernel (built from ``csrc/fused_fleet.cu`` at first
    use: the exact-shape instantiation that holds the topology, else the
    big-topology kernel, one launch per chunk of the batch) or raises:
    when ``nvcc`` is missing, the build fails, or the launch fails. Only a
    CPU ``x0`` takes the plain version."""
    check_admitted(plan)
    if x0.device.type == "cpu":
        return fused_fleet_reference(
            plan, x0, pars, coarse_trips=coarse_trips, refine_trips=refine_trips,
            max_iterations=max_iterations, coarse_tolerance=coarse_tolerance,
            residual_tolerance=residual_tolerance,
            coarse_step_tolerance=coarse_step_tolerance,
            step_tolerance=step_tolerance, initial_lambda=initial_lambda)
    check_inputs(plan, x0, pars)
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    B, n = x0.shape
    if B >= 2 ** 31:
        raise ValueError(f"batch of {B} sketches exceeds the kernel's int32 lane index")
    dev = x0.device
    outs = (torch.empty((B, n), dtype=torch.float64, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.bool, device=dev),
            torch.empty((B, plan.n_constraints), dtype=torch.bool, device=dev),
            torch.empty((B, plan.n_constraints), dtype=torch.bool, device=dev))
    scalars = (coarse_trips, refine_trips, max_iterations,
               coarse_tolerance, coarse_step_tolerance, step_tolerance,
               residual_tolerance, initial_lambda,
               float(np.float32(LM_LAMBDA_DECR)), float(np.float32(LM_LAMBDA_INCR)))
    _build.count_launches(__name__, launch("fused", plan, x0.contiguous(),
                                           param_rows(pars, B, dev), scalars, outs,
                                           f64=True))
    return outs


# -- the plain version ---------------------------------------------------------


def fused_fleet_reference(plan: FleetPlan, x0: torch.Tensor,
                          pars: Sequence[torch.Tensor], *, coarse_trips: int,
                          refine_trips: int, max_iterations: int,
                          coarse_tolerance: float, residual_tolerance: float,
                          coarse_step_tolerance: float, step_tolerance: float,
                          initial_lambda: float) -> Result:
    """The plain version of the fused kernel, in eager torch over (B,)
    tensors: the JAX kernel's ``_residual_rows``, ``_jac_rows``,
    ``_damped_solve_rows`` and ``_chol_solve_rows`` in the same operation
    order, with every trip run and finished lanes masked. Same arguments
    and results as ``fused_fleet_solve``; runs on any device (the card's
    main path never calls it: it is what the kernel is held against)."""
    check_inputs(plan, x0, pars)
    topo = Topology(plan)
    B = x0.shape[0]
    dev = x0.device
    par64 = param_rows(pars, B, dev)
    par32 = par64.float()
    decr = torch.tensor(LM_LAMBDA_DECR, dtype=torch.float32, device=dev)
    incr = torch.tensor(LM_LAMBDA_INCR, dtype=torch.float32, device=dev)
    stol = torch.tensor(step_tolerance, dtype=torch.float32, device=dev)

    # ---- phase 1: f32 LM
    x, lam, deg, coarse_its, _conv = coarse_phase(
        topo, x0, par32, trips=coarse_trips, tolerance=coarse_tolerance,
        step_tolerance=coarse_step_tolerance, initial_lambda=initial_lambda)
    refine_limit = torch.clamp(max_iterations - coarse_its, min=0, max=refine_trips)

    # ---- phase 2: f64 residuals, f32 steps; starts at the coarse point
    xd = [xi.double() for xi in x]
    rd, deg_d, unsat = residual_rows(topo, xd, par64, f64=True)
    deg = deg | deg_d
    r2d = rows_sumsq(rd)
    cnt = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for _trip in range(refine_trips):
        rinf = rows_max_abs(rd)
        res_now = (rinf <= residual_tolerance) & ~done
        act = ~done & ~res_now & (cnt < refine_limit)
        A, jtr, deg_j = normal_equations(
            topo, [xi.float() for xi in xd], par32, [ri.float() for ri in rd])
        d, fail = damped_solve(topo, A, jtr, lam)
        step_inf = rows_max_abs(d)
        x_new = [xi + di.double() for xi, di in zip(xd, d)]
        r_new, deg_r, unsat_new = residual_rows(topo, x_new, par64, f64=True)
        r2_new = rows_sumsq(r_new)
        accept = ~fail & (r2_new < r2d)
        take = act & accept
        xd = [torch.where(take, xn, xo) for xn, xo in zip(x_new, xd)]
        rd = [torch.where(take, rn, ro) for rn, ro in zip(r_new, rd)]
        r2d = torch.where(take, r2_new, r2d)
        unsat = torch.where(take[:, None], unsat_new, unsat)
        lam = torch.where(act, torch.where(accept, lam * decr, lam * incr), lam)
        deg = deg | ((deg_j | deg_r) & act[:, None])
        step_conv = act & ~fail & (step_inf <= stol)
        done = done | res_now | step_conv
        cnt = torch.where(act, cnt + 1, cnt)
    converged = (rows_max_abs(rd) <= residual_tolerance) | done
    x_out = torch.stack(xd, dim=1)
    return x_out, coarse_its + cnt, converged, ~unsat, deg
