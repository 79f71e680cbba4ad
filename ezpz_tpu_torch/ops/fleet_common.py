"""What the two fleet kernels' wrappers and plain versions share.

The Python side of ``csrc/fleet_common.cuh``: the gate check, input
checks, parameter packing and the launch for both wrappers
(``ops/fused_fleet``, ``ops/coarse_fleet``), and
the plain version's residual rows, normal equations, damped Crout solve and
``coarse_phase``, the f32 LM loop both kernels run first. Everything works
in eager torch over lists of (B,) tensors, in the JAX kernels' operation
order (``ezpz_tpu/ops/pallas_fleet.py``).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..config import LM_LAMBDA_DECR, LM_LAMBDA_INCR
from ..utils import debug
from . import _build
from .fleet_plan import (INST_CID, INST_DIM, INST_IDS, INST_KIND, INST_NV,
                         INST_POFF, INST_PK, KERNEL_MAX_FILL,
                         KERNEL_MAX_INSTANCES, FleetPlan)
from .kernels import KERNELS, jvp


def check_inputs(plan: FleetPlan, x0: torch.Tensor, pars: Sequence[torch.Tensor]):
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


def check_admitted(plan: FleetPlan):
    """Raise ``NotImplementedError`` for a plan the kernel gate declines
    (``fleet_plan.kernel_admits``): ``BatchSolver`` routes such a topology
    to its batched mixed path before any launch."""
    if plan.kernel is None:
        raise NotImplementedError(
            f"topology with {plan.n_inst} instances and a planned fill of "
            f"{plan.fill} is outside the fleet kernels' gate (at most "
            f"{KERNEL_MAX_INSTANCES} instances, fill at most {KERNEL_MAX_FILL})")


def launch(entry: str, plan: FleetPlan, x0: torch.Tensor, par: torch.Tensor,
           scalars: tuple, outs: Sequence[torch.Tensor], f64: bool) -> int:
    """Launch a fleet kernel of the library (``entry`` ``"fused"`` or
    ``"coarse"``) on CUDA ``x0`` (B, n) and ``par`` (B, P): the exact-shape
    instantiation that holds the plan (``_build.small_shape``) in one
    launch, else the big-topology kernel over chunks of the batch with
    lane-interleaved scratch (``_build.big_slots``). ``scalars``: the trip
    counts and tolerances after the tables; ``outs``: the output tensors,
    batch first. Raises ``RuntimeError`` on a refused launch (and, with a
    NaN/Inf switch armed, ``FloatingPointError`` on such an output);
    returns the number of launches."""
    lib = _build.load_library()
    dev = x0.device
    B, n = x0.shape
    P = par.shape[1]
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    shape = _build.small_shape(plan)
    k = plan.kernel

    def check(err):
        if err != 0:
            raise RuntimeError(f"{entry} fleet kernel launch failed: cudaError {err} "
                               f"({_build.error_string(lib, err)})")

    with torch.cuda.device(dev):
        if shape is not None:
            check(getattr(lib, f"ezpz_{entry}_fleet_small")(
                *shape, x0.data_ptr(), par.data_ptr(), B, n, plan.n_constraints, P,
                k["kinst"].ctypes.data, plan.n_inst, plan.w32.ctypes.data,
                plan.w64.ctypes.data, plan.perm.ctypes.data, k["fill_bits"],
                *scalars, *(o.data_ptr() for o in outs), stream))
            launches = 1
        else:
            fn = getattr(lib, f"ezpz_{entry}_fleet_big")
            # Held until the launches are queued: the kernel reads them.
            held = plan.device_tables(dev)
            tables = [t.data_ptr() for t in held]
            n32, n64 = _build.big_slots(plan, f64)
            spans = _build.chunks(B, 4 * n32 + 8 * n64)
            for lo, hi in spans:
                fscr = torch.empty((n32, hi - lo), dtype=torch.float32, device=dev)
                dscr = torch.empty((max(n64, 1), hi - lo), dtype=torch.float64, device=dev)
                check(fn(x0[lo:hi].data_ptr(), par[lo:hi].data_ptr(), hi - lo, n,
                         plan.n_constraints, P, tables[0], plan.n_inst, *tables[1:],
                         plan.fill, fscr.data_ptr(), dscr.data_ptr(), *scalars,
                         *(o[lo:hi].data_ptr() for o in outs), stream))
            launches = len(spans)
    debug.check_outputs(f"the {entry} fleet kernel", *outs)
    return launches


def param_rows(pars: Sequence[torch.Tensor], B: int, device) -> torch.Tensor:
    """(B, P) float64: every block's parameters, concatenated per sketch in
    block order (the offsets of ``FleetPlan.inst``). A single block with
    parameters is passed through without a copy when it is contiguous."""
    nonempty = [p.reshape(B, -1) for p in pars if p.shape[1] * p.shape[2]]
    if len(nonempty) == 1:
        return nonempty[0].contiguous()
    if not nonempty:
        return torch.zeros((B, 0), dtype=torch.float64, device=device)
    return torch.cat(nonempty, dim=1)


# -- the plain versions --------------------------------------------------------


def rows_max_abs(rows):
    """NaN-propagating max of |row| over a list of (B,) tensors."""
    m = torch.abs(rows[0])
    for r in rows[1:]:
        m = torch.maximum(m, torch.abs(r))
    return m


def rows_sumsq(rows):
    s = rows[0] * rows[0]
    for r in rows[1:]:
        s = s + r * r
    return s


class Topology:
    """Per-instance records of a plan, for the plain versions."""

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


def residual_rows(topo, xs, par, f64):
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


def normal_equations(topo, xs, par, rhs):
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
            _res, dres, dg = jvp(lambda *vv: fn(vv, p), v, tangent)
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


def damped_solve(topo, A, jtr, lam):
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


def coarse_phase(topo: Topology, x0: torch.Tensor, par32: torch.Tensor, *,
                 trips: int, tolerance: float, step_tolerance: float,
                 initial_lambda: float):
    """Phase 1 of both fleet kernels in eager torch: ``trips`` f32 LM trips
    from ``x0`` (B, n) float64, toward ``tolerance`` and ``step_tolerance``
    scaled per lane by ``max(1, |x0|_inf)`` (floored at 1e-7 times it).

    Returns ``(x, lam, deg, iterations, converged)``: x as a list of (B,)
    f32 rows, the carried f32 lambda, degenerate flags (B, n_cons), and the
    JAX coarse kernel's iteration count and converged flag
    (pallas_fleet.py:753-759)."""
    n = topo.n
    B = x0.shape[0]
    dev = x0.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    ctol, cstol = f32(tolerance), f32(step_tolerance)
    decr, incr = f32(LM_LAMBDA_DECR), f32(LM_LAMBDA_INCR)
    x0hi = x0.float()
    x = [x0hi[:, j] for j in range(n)]

    # Per-lane scale of the coarse tolerances.
    scale = torch.ones((B,), dtype=torch.float32, device=dev)
    for j in range(n):
        scale = torch.maximum(scale, torch.abs(x[j]))
    ctol_l = torch.maximum(ctol, scale * 1e-7)
    cstol_l = torch.maximum(cstol, scale * 1e-7)

    r, deg, _ = residual_rows(topo, x, par32, f64=False)
    r2 = rows_sumsq(r)
    lam = torch.full((B,), initial_lambda, dtype=torch.float32, device=dev)
    it = torch.zeros((B,), dtype=torch.int32, device=dev)
    iters = torch.zeros_like(it)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for _trip in range(trips):
        rinf = rows_max_abs(r)
        res_now = (rinf <= ctol_l) & ~done
        act = ~done & ~res_now
        A, jtr, deg_j = normal_equations(topo, x, par32, r)
        d, fail = damped_solve(topo, A, jtr, lam)
        step_inf = rows_max_abs(d)
        x_new = [xi + di for xi, di in zip(x, d)]
        r_new, deg_r, _ = residual_rows(topo, x_new, par32, f64=False)
        r2_new = rows_sumsq(r_new)
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
    res_conv = rows_max_abs(r) <= ctol_l
    iterations = torch.where(
        done, iters, torch.where(res_conv, it, torch.full_like(it, trips)))
    return x, lam, deg, iterations, done | res_conv
