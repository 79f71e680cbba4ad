"""The coarse fleet solver: CUDA kernel, binding and plain version.

Replaces ``ezpz_tpu.ops.pallas_fleet.make_coarse_fleet_solver``. For every
sketch of a fleet that shares one topology, it runs ``trips`` f32
Levenberg-Marquardt trips toward the per-lane tolerance
``max(tol, 1e-7 * max(1, |x0|_inf))`` (the step tolerance is floored the
same way): Jacobian columns by forward mode, JtJ/Jtr, the diagonal damped
by ``max(lambda, 1e-6 * max|diag|)``, Crout on the planned fill, a step
accepted only if ``|r|^2`` strictly drops, converged lanes frozen. Inputs
are rounded to f32 in the kernel, as ``pack_fleet`` rounds them.

It is phase 1 of the fused kernel (``ops/fused_fleet``) on its own: the
CUDA kernel (``csrc/coarse_fleet.cu``) and the fused one call the same
device function (``csrc/fleet_common.cuh``), and the plain version here
and the fused plain version call the same ``fleet_common.coarse_phase``.
``BatchSolver(pallas_coarse=True, pallas_fused=False)`` hands its output to
the batched f64-residual ``solver.solve_lm_refine``.

``coarse_fleet_solve`` dispatches on the device of ``x0``: a CUDA tensor
launches the kernel or raises; a CPU tensor takes ``coarse_fleet_reference``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import LM_LAMBDA_DECR, LM_LAMBDA_INCR
from . import _build
from .fleet_common import (Topology, check_admitted, check_inputs, coarse_phase,
                           launch, param_rows)
from .fleet_plan import FleetPlan

# Kernel launches made by ``coarse_fleet_solve`` in this process.
LAUNCHES = 0

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def coarse_fleet_solve(plan: FleetPlan, x0: torch.Tensor,
                       pars: Sequence[torch.Tensor], *, trips: int,
                       tolerance: float, step_tolerance: float,
                       initial_lambda: float) -> Result:
    """Coarse-solve a fleet: ``x0`` (B, n) float64, ``pars`` per block
    (B, n_k, p_k) float64, ``trips`` f32 LM trips toward the O(1)-coordinate
    ``tolerance`` and ``step_tolerance`` (scaled per lane), from damping
    ``initial_lambda``. Returns ``(x (B, n) float32, iterations (B,) int32,
    converged (B,) bool, degenerate (B, n_cons) bool)``.

    A plan outside the kernel gate raises ``NotImplementedError`` on any
    device. Otherwise a CUDA ``x0`` launches the hand-written kernel
    (built from ``csrc/`` at first use; the exact-shape instantiation that
    holds the topology, else the big-topology kernel per chunk of the
    batch) or raises: when ``nvcc`` is missing, the build fails, or the
    launch fails. Only a CPU ``x0`` takes the plain version."""
    check_admitted(plan)
    if x0.device.type == "cpu":
        return coarse_fleet_reference(plan, x0, pars, trips=trips,
                                      tolerance=tolerance,
                                      step_tolerance=step_tolerance,
                                      initial_lambda=initial_lambda)
    check_inputs(plan, x0, pars)
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    B, n = x0.shape
    if B >= 2 ** 31:
        raise ValueError(f"batch of {B} sketches exceeds the kernel's int32 lane index")
    dev = x0.device
    outs = (torch.empty((B, n), dtype=torch.float32, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.bool, device=dev),
            torch.empty((B, plan.n_constraints), dtype=torch.bool, device=dev))
    scalars = (trips, tolerance, step_tolerance, initial_lambda,
               float(np.float32(LM_LAMBDA_DECR)), float(np.float32(LM_LAMBDA_INCR)))
    _build.count_launches(__name__, launch("coarse", plan, x0.contiguous(),
                                           param_rows(pars, B, dev), scalars, outs,
                                           f64=False))
    return outs


def coarse_fleet_reference(plan: FleetPlan, x0: torch.Tensor,
                           pars: Sequence[torch.Tensor], *, trips: int,
                           tolerance: float, step_tolerance: float,
                           initial_lambda: float) -> Result:
    """The plain version of the coarse kernel in eager torch over (B,)
    tensors: the JAX kernel's body in the same operation order, every trip
    run with finished lanes masked. Same arguments and results as
    ``coarse_fleet_solve``; runs on any device (the card's main path never
    calls it: it is what the kernel is held against)."""
    check_inputs(plan, x0, pars)
    par32 = param_rows(pars, x0.shape[0], x0.device).float()
    x, _lam, deg, iterations, converged = coarse_phase(
        Topology(plan), x0, par32, trips=trips, tolerance=tolerance,
        step_tolerance=step_tolerance, initial_lambda=initial_lambda)
    return torch.stack(x, dim=1), iterations, converged, deg
