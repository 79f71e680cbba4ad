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
takes ``fused_fleet_reference``, the same algorithm in eager torch.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import LM_LAMBDA_DECR, LM_LAMBDA_INCR
from . import _build
from .fleet_plan import (INST_CID, INST_DIM, INST_IDS, INST_KIND, INST_NV,
                         INST_POFF, INST_PK, FleetPlan)
from .kernels import KERNELS

# Kernel launches made by ``fused_fleet_solve`` in this process.
LAUNCHES = 0

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
               torch.Tensor]


def _check_inputs(plan: FleetPlan, x0: torch.Tensor, pars: Sequence[torch.Tensor]):
    if x0.dtype != torch.float64 or x0.dim() != 2 or x0.shape[1] != plan.n_vars:
        raise ValueError(f"x0 must be (B, {plan.n_vars}) float64, got "
                         f"{tuple(x0.shape)} {x0.dtype}")
    if len(pars) != len(plan.par_cols):
        raise ValueError(f"expected {len(plan.par_cols)} parameter blocks, "
                         f"got {len(pars)}")
    B = x0.shape[0]
    for p, (_off, width) in zip(pars, plan.par_cols):
        if (p.dtype != torch.float64 or p.device != x0.device
                or p.dim() != 3 or p.shape[0] != B
                or p.shape[1] * p.shape[2] != width):
            raise ValueError(f"parameter block must be (B={B}, n_k, p_k) float64 "
                             f"on {x0.device} with n_k*p_k={width}, got "
                             f"{tuple(p.shape)} {p.dtype} on {p.device}")


def _param_rows(pars: Sequence[torch.Tensor], B: int, device) -> torch.Tensor:
    """(B, P) float64: every block's parameters, concatenated per sketch in
    block order (the offsets of ``FleetPlan.inst``). A single block with
    parameters is passed through without a copy when it is contiguous."""
    nonempty = [p.reshape(B, -1) for p in pars if p.shape[1] * p.shape[2]]
    if len(nonempty) == 1:
        return nonempty[0].contiguous()
    if not nonempty:
        return torch.zeros((B, 0), dtype=torch.float64, device=device)
    return torch.cat(nonempty, dim=1)


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

    A CUDA ``x0`` launches the hand-written kernel (built from
    ``csrc/fused_fleet.cu`` at first use) or raises: when ``nvcc`` is
    missing, the build fails, the topology exceeds every compiled
    capacity, or the launch fails. Only a CPU ``x0`` takes the plain
    version."""
    global LAUNCHES
    if x0.device.type == "cpu":
        return fused_fleet_reference(
            plan, x0, pars, coarse_trips=coarse_trips, refine_trips=refine_trips,
            max_iterations=max_iterations, coarse_tolerance=coarse_tolerance,
            residual_tolerance=residual_tolerance,
            coarse_step_tolerance=coarse_step_tolerance,
            step_tolerance=step_tolerance, initial_lambda=initial_lambda)
    _check_inputs(plan, x0, pars)
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    B, n = x0.shape
    if B >= 2 ** 31:
        raise ValueError(f"batch of {B} sketches exceeds the kernel's int32 lane index")
    cap = _build.capacity_for(plan)
    lib = _build.load_library()
    dev = x0.device
    x0c = x0.contiguous()
    par = _param_rows(pars, B, dev)
    inst, w32, w64, perm, inv, nzl = plan.device_tables(dev)
    x_out = torch.empty((B, n), dtype=torch.float64, device=dev)
    it_out = torch.empty((B,), dtype=torch.int32, device=dev)
    conv_out = torch.empty((B,), dtype=torch.bool, device=dev)
    sat_out = torch.empty((B, plan.n_constraints), dtype=torch.bool, device=dev)
    deg_out = torch.empty((B, plan.n_constraints), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.ezpz_fused_fleet(
            cap[0], cap[1],
            x0c.data_ptr(), par.data_ptr(), B, n, plan.n_rows,
            plan.n_constraints, par.shape[1],
            inst.data_ptr(), plan.n_inst, w32.data_ptr(), w64.data_ptr(),
            perm.data_ptr(), inv.data_ptr(), nzl.data_ptr(),
            coarse_trips, refine_trips, max_iterations,
            coarse_tolerance, coarse_step_tolerance, step_tolerance,
            residual_tolerance, initial_lambda,
            float(np.float32(LM_LAMBDA_DECR)), float(np.float32(LM_LAMBDA_INCR)),
            x_out.data_ptr(), it_out.data_ptr(), conv_out.data_ptr(),
            sat_out.data_ptr(), deg_out.data_ptr(), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"fused fleet kernel launch failed: cudaError {err} "
                           f"({_build.error_string(lib, err)})")
    LAUNCHES += 1
    return x_out, it_out, conv_out, sat_out, deg_out


# -- the plain version ---------------------------------------------------------


def _rows_max_abs(rows):
    """NaN-propagating max of |row| over a list of (B,) tensors."""
    m = torch.abs(rows[0])
    for r in rows[1:]:
        m = torch.maximum(m, torch.abs(r))
    return m


def _rows_sumsq(rows):
    s = rows[0] * rows[0]
    for r in rows[1:]:
        s = s + r * r
    return s


class _Topology:
    """Per-instance records of a plan, for the plain version."""

    def __init__(self, plan: FleetPlan):
        names = list(KERNELS)
        self.n = plan.n_vars
        self.n_cons = plan.n_constraints
        self.perm = [int(v) for v in plan.perm]
        self.inv = [0] * self.n
        for k, v in enumerate(self.perm):
            self.inv[v] = k
        self.nz = plan.nzl.astype(bool)
        self.insts = []
        for row in range(plan.n_inst):
            rec = plan.inst[row]
            nv = int(rec[INST_NV])
            self.insts.append((
                KERNELS[names[int(rec[INST_KIND])]].fn,
                [int(j) for j in rec[INST_IDS:INST_IDS + nv]],
                int(rec[INST_DIM]), int(rec[INST_CID]),
                int(rec[INST_POFF]), int(rec[INST_PK]),
                float(plan.w32[row]), float(plan.w64[row]),
            ))


def _residual_rows(topo, xs, par, f64):
    """Weighted residual rows (list of (B,)), degenerate flags (B, n_cons)
    and, in f64, unsatisfied flags (B, n_cons): some unweighted row of the
    constraint is not below 1e-4 (NaN included)."""
    B = xs[0].shape[0]
    rows = []
    deg = torch.zeros((B, topo.n_cons), dtype=torch.bool, device=xs[0].device)
    unsat = torch.zeros_like(deg) if f64 else None
    for fn, ids, dim, cid, poff, pk, w32, w64 in topo.insts:
        res, dg = fn([xs[j] for j in ids], [par[:, poff + k] for k in range(pk)])
        w = w64 if f64 else w32
        for d in range(dim):
            if f64:
                unsat[:, cid] |= ~(torch.abs(res[d]) < 1e-4)
            rows.append(res[d] * w)
        deg[:, cid] |= dg
    return rows, deg, unsat


def _normal_equations(topo, xs, par, rhs):
    """f32 JtJ (lower triangle of the PERMUTED matrix, dict (i, j) ->
    (B,)), Jtr (list of (B,)) against ``rhs`` rows, and the degenerate
    flags of the evaluation. Jacobian columns come from ``torch.func.jvp``
    with one-hot tangents, one per instance variable."""
    n = topo.n
    B = xs[0].shape[0]
    zero = torch.zeros_like(xs[0])
    one = torch.ones_like(xs[0])
    A = {}
    jtr = [zero] * n
    deg = torch.zeros((B, topo.n_cons), dtype=torch.bool, device=xs[0].device)
    row = 0
    for fn, ids, dim, cid, poff, pk, w, _w64 in topo.insts:
        v = tuple(xs[j] for j in ids)
        p = [par[:, poff + k] for k in range(pk)]
        cols = []
        for a in range(len(ids)):
            tangent = tuple(one if r == a else zero for r in range(len(ids)))
            _res, dres, dg = torch.func.jvp(lambda *vv: fn(vv, p), v, tangent,
                                            has_aux=True)
            cols.append(dres)
        wres = rhs[row:row + dim]
        row += dim
        for a, ga in enumerate(ids):
            acc = (cols[a][0] * w) * wres[0]
            for d in range(1, dim):
                acc = acc + (cols[a][d] * w) * wres[d]
            jtr[ga] = jtr[ga] + acc
            for b, gb in enumerate(ids):
                pa, pb = topo.inv[ga], topo.inv[gb]
                if pa < pb:
                    continue
                acc2 = (cols[a][0] * w) * (cols[b][0] * w)
                for d in range(1, dim):
                    acc2 = acc2 + (cols[a][d] * w) * (cols[b][d] * w)
                A[pa, pb] = A.get((pa, pb), zero) + acc2
        deg[:, cid] |= dg
    return A, jtr, deg


def _damped_solve(topo, A, jtr, lam):
    """Damp, factor (Crout on the planned fill, in the planned order) and
    solve. Returns (step rows in the original order, fail (B,) bool): a NaN
    on the factor's diagonal fails the lane, whose step is zero."""
    n, nz = topo.n, topo.nz
    zero = torch.zeros_like(jtr[0])
    maxdiag = torch.abs(A.get((0, 0), zero))
    for i in range(1, n):
        maxdiag = torch.maximum(maxdiag, torch.abs(A.get((i, i), zero)))
    lam_eff = torch.maximum(lam, maxdiag * 1e-6)
    L = {}
    for i in range(n):
        L[i, i] = A.get((i, i), zero) + lam_eff
    for i in range(n):
        for j in range(i + 1):
            if not nz[i, j]:
                continue
            s = L[i, i] if i == j else A.get((i, j), zero)
            for k in range(j):
                if nz[i, k] and nz[j, k]:
                    s = s - L[i, k] * L[j, k]
            L[i, j] = torch.sqrt(s) if i == j else s / L[j, j]
    fail = torch.isnan(L[0, 0])
    for i in range(1, n):
        fail = fail | torch.isnan(L[i, i])
    for i in range(n):
        di = L[i, i]
        L[i, i] = torch.where(torch.isnan(di) | (di == 0.0), 1.0, di)
        for k in range(i):
            if nz[i, k]:
                L[i, k] = torch.where(torch.isnan(L[i, k]), 0.0, L[i, k])
    y = [None] * n
    for i in range(n):
        s = -jtr[topo.perm[i]]
        for k in range(i):
            if nz[i, k]:
                s = s - L[i, k] * y[k]
        y[i] = s / L[i, i]
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            if nz[k, i]:
                s = s - L[k, i] * y[k]
        y[i] = s / L[i, i]
    d = [None] * n
    for k in range(n):
        d[topo.perm[k]] = torch.where(fail, zero, y[k])
    return d, fail


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
    _check_inputs(plan, x0, pars)
    topo = _Topology(plan)
    n = plan.n_vars
    B = x0.shape[0]
    dev = x0.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    par64 = _param_rows(pars, B, dev)
    par32 = par64.float()
    ctol, cstol, stol = (f32(coarse_tolerance), f32(coarse_step_tolerance),
                         f32(step_tolerance))
    decr, incr = f32(LM_LAMBDA_DECR), f32(LM_LAMBDA_INCR)
    x0hi = x0.float()
    x = [x0hi[:, j] for j in range(n)]

    # Per-lane scale of the coarse tolerances.
    scale = torch.ones((B,), dtype=torch.float32, device=dev)
    for j in range(n):
        scale = torch.maximum(scale, torch.abs(x[j]))
    ctol_l = torch.maximum(ctol, scale * 1e-7)
    cstol_l = torch.maximum(cstol, scale * 1e-7)

    # ---- phase 1: f32 LM
    r, deg, _ = _residual_rows(topo, x, par32, f64=False)
    r2 = _rows_sumsq(r)
    lam = torch.full((B,), initial_lambda, dtype=torch.float32, device=dev)
    it = torch.zeros((B,), dtype=torch.int32, device=dev)
    iters = torch.zeros_like(it)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for _trip in range(coarse_trips):
        rinf = _rows_max_abs(r)
        res_now = (rinf <= ctol_l) & ~done
        act = ~done & ~res_now
        A, jtr, deg_j = _normal_equations(topo, x, par32, r)
        d, fail = _damped_solve(topo, A, jtr, lam)
        step_inf = _rows_max_abs(d)
        x_new = [xi + di for xi, di in zip(x, d)]
        r_new, deg_r, _ = _residual_rows(topo, x_new, par32, f64=False)
        r2_new = _rows_sumsq(r_new)
        accept = ~fail & (r2_new < r2)
        take = act & accept
        x = [torch.where(take, xn, xo) for xn, xo in zip(x_new, x)]
        r = [torch.where(take, rn, ro) for rn, ro in zip(r_new, r)]
        r2 = torch.where(take, r2_new, r2)
        lam = torch.where(act, torch.where(accept, lam * decr, lam * incr), lam)
        deg = deg | ((deg_j | deg_r) & act[:, None])
        step_conv = act & ~fail & (step_inf <= cstol_l)
        iters = torch.where(res_now | step_conv, it, iters)
        done = done | res_now | step_conv
        it = torch.where(act, it + 1, it)
    res_conv = _rows_max_abs(r) <= ctol_l
    coarse_its = torch.where(
        done, iters,
        torch.where(res_conv, it, torch.full_like(it, coarse_trips)))
    refine_limit = torch.clamp(max_iterations - coarse_its, min=0, max=refine_trips)

    # ---- phase 2: f64 residuals, f32 steps; starts at the coarse point
    xd = [xi.double() for xi in x]
    rd, deg_d, unsat = _residual_rows(topo, xd, par64, f64=True)
    deg = deg | deg_d
    r2d = _rows_sumsq(rd)
    cnt = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for _trip in range(refine_trips):
        rinf = _rows_max_abs(rd)
        res_now = (rinf <= residual_tolerance) & ~done
        act = ~done & ~res_now & (cnt < refine_limit)
        A, jtr, deg_j = _normal_equations(
            topo, [xi.float() for xi in xd], par32, [ri.float() for ri in rd])
        d, fail = _damped_solve(topo, A, jtr, lam)
        step_inf = _rows_max_abs(d)
        x_new = [xi + di.double() for xi, di in zip(xd, d)]
        r_new, deg_r, unsat_new = _residual_rows(topo, x_new, par64, f64=True)
        r2_new = _rows_sumsq(r_new)
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
    converged = (_rows_max_abs(rd) <= residual_tolerance) | done
    x_out = torch.stack(xd, dim=1)
    return x_out, coarse_its + cnt, converged, ~unsat, deg
