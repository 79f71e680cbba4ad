"""Single-device partitioned Schur solve for coupled systems.

The PyTorch counterpart of ``ezpz_tpu/parallel/block_schur.py``. A coupled
(not block-diagonal) system splits its variables into P contiguous parts;
the variables that a constraint spanning two parts touches form the
boundary B. Each LM step solves the damped normal equations

    A = [[A_II, A_IB],    A_II block-diagonal over the parts
         [A_BI, A_BB]]

by a Schur complement:

    per part p:  W_p = A_pp^-1 A_pB,   u_p = A_pp^-1 b_p
    S   = A_BB + lambda I - sum_p A_pB^T W_p
    x_B = S^-1 rhs
    x_p = u_p - W_p x_B

All P interior factorizations of all B lanes run as one batch (the unrolled
Crout of ``ops.linalg`` for interiors of at most 24 variables), and each
part carries only its local boundary variables, so memory stays
O(P * (m + k_b)^2) per lane. The boundary is solved densely, by
Jacobi-preconditioned CG on the matrix-free Schur operator, or as a band
(the hand-written kernel of ``ops.banded_spd`` on the card).

Residuals, accept/reject and convergence run through the port's batched LM
loop (``solver._lm_while_loop``) on the f64 compiled system, as in the JAX
package; ``precision="mixed"`` drops only the Jacobian, the normal
equations and the factorizations to f32.

Every sum that the JAX package forms with a scatter-add (JtJ and Jtr per
part, the boundary right-hand side, the band, the dense S, the CG matvec)
is a fixed gather and a sum in a fixed order here, planned at construction
from the static maps: on the card the results do not change from run to
run. The f32 contractions need full f32 matrix products; a solve on a CUDA
device raises if PyTorch's float32 matmul precision allows TF32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..constraints import Constraint
from ..models.compiled import CompiledSystem, KindBlock, compile_system, gather_sum
from ..ops.banded import banded_spd_solve
from ..ops.kernels import KERNELS
from ..ops.linalg import spd_solve, spd_solve_batched, spd_solve_multi_batched
from ..solver import (LMResult, _cg, _init_state, _lm_while_loop, _reference_result,
                      pack_result, resolve_device, unpack_solver_result)
from .schur import partition_variables, require_full_f32, resolve_boundary_solver


class _SegmentSum:
    """A scatter-add with a static map, as fixed gathers and adds: input
    column c goes to output slot ``targets[c]`` (dropped when out of
    ``[0, n_out)``), each slot summing its inputs in increasing column
    order, as the JAX package's CPU scatter does."""

    def __init__(self, targets: np.ndarray, n_out: int, device):
        targets = np.asarray(targets).reshape(-1)
        lists: dict = {}
        for c, t in enumerate(targets.tolist()):
            if 0 <= t < n_out:
                lists.setdefault(t, []).append(c)
        entries = sorted(lists)
        width = max((len(v) for v in lists.values()), default=0)
        gather = np.full((len(entries), width), targets.size, dtype=np.int64)
        for row, e in enumerate(entries):
            gather[row, :len(lists[e])] = lists[e]
        self.n_out = n_out
        self.entries = torch.as_tensor(np.asarray(entries, np.int64), device=device)
        self.gather = torch.as_tensor(gather, device=device)

    def __call__(self, vals: torch.Tensor) -> torch.Tensor:
        """(B, n_in) -> (B, n_out)."""
        return gather_sum(vals, self.entries, self.gather, self.n_out)


@dataclass
class PartPlan:
    """The host-side (numpy) plan of a partitioned-Schur solve: P parts,
    stacked over ``rows >= P`` part rows (the rows past P empty, for an
    even split over ranks). ``l2g`` (rows, m + kb) gathers a part's local
    vector from x (slot n_vars reads an appended zero); ``bmap`` (rows, kb)
    sends its boundary entries to the global boundary (slot n_b: dropped);
    ``int_map`` (rows, m) sends its interior steps out (slot n_vars:
    dropped); ``imask`` (rows, m) marks real interior slots; the band of
    half-bandwidth ``band_bw`` takes entry (p, k, j) to row ``band_rows``
    at offset ``band_off`` (offset bw + 1: dropped). ``jblocks`` holds per
    kernel kind ``(spec, idx, par, wgt, cid)``, (rows, n_max, ...), with
    local indices; padded instances have slot 0, zero parameters and
    weight, and constraint id ``n_constraints``."""

    n_vars: int
    P: int
    boundary: List[int]
    n_b: int
    m: int
    kb: int
    l2g: np.ndarray
    bmap: np.ndarray
    int_map: np.ndarray
    imask: np.ndarray
    band_bw: int
    band_rows: np.ndarray
    band_off: np.ndarray
    jblocks: list


def plan_parts(constraints: Sequence[Constraint], n_vars: int, part_of_var: np.ndarray,
               weights: Sequence[float], rows: Optional[int] = None) -> PartPlan:
    """Plan the parts of ``part_of_var`` (the JAX package's layout, one
    pass over the variables and one over the constraints)."""
    part_of_var = np.asarray(part_of_var)
    P = int(part_of_var.max()) + 1 if n_vars else 1
    rows = P if rows is None else rows
    n_cons = len(constraints)
    _pv, boundary = partition_variables(constraints, n_vars, P, part_of_var)
    bset = set(boundary)
    n_b = len(boundary)
    b_slot = {g: j for j, g in enumerate(boundary)}
    interior: List[List[int]] = [[] for _ in range(P)]
    for v in range(n_vars):
        if v not in bset:
            interior[int(part_of_var[v])].append(v)
    m = max((len(iv) for iv in interior), default=0)

    # Constraint -> part: single-home constraints to their part,
    # all-boundary couplers round-robin.
    per_part: List[List[int]] = [[] for _ in range(P)]
    rr = 0
    for cid, c in enumerate(constraints):
        homes = {int(part_of_var[v]) for v in c.dependent_variable_ids()}
        if len(homes) == 1:
            per_part[homes.pop()].append(cid)
        else:
            per_part[rr % P].append(cid)
            rr += 1

    # Per-part LOCAL boundary: only the boundary variables its
    # constraints touch.
    local_b = [
        sorted({v for cid in per_part[p]
                for v in constraints[cid].dependent_variable_ids() if v in bset})
        for p in range(P)
    ]
    kb = max((len(t) for t in local_b), default=0)
    n_loc = m + kb

    l2g = np.full((rows, n_loc), n_vars, dtype=np.int32)
    g2l = [dict() for _ in range(P)]
    bmap = np.full((rows, kb), n_b, dtype=np.int32)
    int_map = np.full((rows, m), n_vars, dtype=np.int32)
    imask = np.zeros((rows, m))
    for p in range(P):
        for i, g in enumerate(interior[p]):
            l2g[p, i] = g
            g2l[p][g] = i
            int_map[p, i] = g
        for j, g in enumerate(local_b[p]):
            l2g[p, m + j] = g
            g2l[p][g] = m + j
            bmap[p, j] = b_slot[g]
        imask[p, : len(interior[p])] = 1.0

    # The band: half-bandwidth = widest within-part boundary span under
    # the natural ordering (a part's Schur block couples only its own
    # boundary slots, so the lower band captures S exactly). Each
    # (part, k, j) block entry maps to (row slot, band offset); upper-
    # triangle and dummy entries get out-of-range offsets (dropped).
    spans = [
        int(r.max() - r.min())
        for p in range(rows)
        for r in (bmap[p][bmap[p] < n_b],)
        if r.size
    ]
    bw = max(spans, default=0)
    brows = np.repeat(bmap[:, :, None], kb, axis=2)
    bcols = np.repeat(bmap[:, None, :], kb, axis=1)
    off = bcols - brows + bw
    invalid = (brows >= n_b) | (bcols >= n_b) | (off < 0) | (off > bw)

    per_part_kinds: List[dict] = []
    for p in range(P):
        slots: dict = {}
        for cid in per_part[p]:
            for inst in constraints[cid].lower():
                ks = slots.setdefault(
                    inst.kernel, {"idx": [], "par": [], "w": [], "cid": []}
                )
                ks["idx"].append(tuple(g2l[p][v] for v in inst.var_ids))
                ks["par"].append(inst.params)
                ks["w"].append(weights[cid])
                ks["cid"].append(cid)
        per_part_kinds.append(slots)
    jblocks = []
    for kind in sorted({k for s in per_part_kinds for k in s}):
        spec = KERNELS[kind]
        n_max = max(len(per_part_kinds[p].get(kind, {"idx": []})["idx"])
                    for p in range(P))
        idx = np.zeros((rows, n_max, spec.nvars), dtype=np.int32)
        par = np.zeros((rows, n_max, spec.nparams), dtype=np.float64)
        wgt = np.zeros((rows, n_max), dtype=np.float64)
        cid = np.full((rows, n_max), n_cons, dtype=np.int32)
        for p in range(P):
            ks = per_part_kinds[p].get(kind)
            if not ks or not ks["idx"]:
                continue
            nn = len(ks["idx"])
            idx[p, :nn] = np.asarray(ks["idx"], np.int32)
            par[p, :nn] = np.asarray(ks["par"], np.float64).reshape(nn, spec.nparams)
            wgt[p, :nn] = ks["w"]
            cid[p, :nn] = ks["cid"]
        jblocks.append((spec, idx, par, wgt, cid))
    return PartPlan(n_vars=n_vars, P=P, boundary=boundary, n_b=n_b, m=m, kb=kb, l2g=l2g, bmap=bmap,
                    int_map=int_map, imask=imask, band_bw=bw,
                    band_rows=np.where(invalid, n_b, brows),
                    band_off=np.where(invalid, bw + 1, off), jblocks=jblocks)


def part_system(plan: PartPlan, lo: int, hi: int, n_constraints: int,
                dtype: torch.dtype, unweighted_to_dummy: bool = False) -> CompiledSystem:
    """Parts ``lo:hi`` as one system over their flattened local vectors
    (parts of m + kb variables; constraint slot ``n_constraints`` is the
    padding's). ``unweighted_to_dummy`` sends weight-0 instances to that
    slot too, so that they neither flag degenerate nor count as
    unsatisfied (the sharded solver's rule)."""
    n_loc = plan.m + plan.kb
    offs = (np.arange(hi - lo, dtype=np.int32) * n_loc)[:, None, None]
    blocks = []
    for spec, idx, par, wgt, cid in plan.jblocks:
        idx, par, wgt, cid = idx[lo:hi], par[lo:hi], wgt[lo:hi], cid[lo:hi]
        if unweighted_to_dummy:
            cid = np.where(wgt > 0, cid, n_constraints)
        blocks.append(KindBlock(spec=spec, idx=(idx + offs).reshape(wgt.size, spec.nvars),
                                par=par.reshape(wgt.size, spec.nparams),
                                weight=wgt.reshape(-1), cid=cid.reshape(-1)))
    return CompiledSystem(
        n_vars=(hi - lo) * n_loc, n_constraints=n_constraints + 1,
        n_rows=sum(b.idx.shape[0] * b.spec.dim for b in blocks),
        blocks=tuple(blocks), part_size=n_loc,
    ).astype(dtype)


def part_index_tensors(plan: PartPlan, lo: int, hi: int, dev) -> Tuple[torch.Tensor, ...]:
    """Parts ``lo:hi``'s gathers on ``dev``: ``l2g`` and ``bmap``
    flattened, the interior steps' source (flat local slot) and
    destination (variable) for real slots, and the boundary ids."""
    def as_long(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    int_map = plan.int_map[lo:hi].reshape(-1)
    real = int_map < plan.n_vars
    return (as_long(plan.l2g[lo:hi].reshape(-1)), as_long(plan.bmap[lo:hi].reshape(-1)),
            as_long(np.flatnonzero(real)), as_long(int_map[real]), as_long(plan.boundary))


def part_segment_sums(plan: PartPlan, lo: int, hi: int, boundary_solver: str, dev):
    """Parts ``lo:hi``'s fixed-order sums into the boundary: the (n_b,)
    vector, and the band (banded boundary) or the dense (n_b, n_b) matrix
    (dense boundary), else None."""
    n_b, bw, kb = plan.n_b, plan.band_bw, plan.kb
    bmap = plan.bmap[lo:hi]
    band = dense = None
    if boundary_solver == "banded":
        rows, off = plan.band_rows[lo:hi], plan.band_off[lo:hi]
        band = _SegmentSum(np.where(off > bw, -1, rows * (bw + 1) + off),
                           n_b * (bw + 1), dev)
    elif boundary_solver == "dense":
        rows = np.repeat(bmap[:, :, None], kb, axis=2)
        cols = np.repeat(bmap[:, None, :], kb, axis=1)
        dense = _SegmentSum(np.where((rows >= n_b) | (cols >= n_b), -1, rows * n_b + cols),
                            n_b * n_b, dev)
    return _SegmentSum(bmap, n_b, dev), band, dense


def damped_blocks(jtj, jtr, lam_j, imask, m):
    """The damped per-part blocks of normal equations ``jtj`` (B, P, n_loc,
    n_loc), ``jtr`` (B, P, n_loc) with ``lam_j`` (B,): ``(A_ii, A_iB,
    A_BB, b_i, b_B)``, a unit diagonal on padded interior slots (``imask``
    (P, m) zero) keeping A_ii SPD."""
    eye_m = torch.eye(m, dtype=jtj.dtype, device=jtj.device)
    a_ii = (jtj[..., :m, :m]
            + lam_j[:, None, None, None] * eye_m * imask[:, None, :]
            + (1.0 - imask)[:, :, None] * eye_m)
    return a_ii, jtj[..., :m, m:], jtj[..., m:, m:], -jtr[..., :m], -jtr[..., m:]


def interior_solve(a_ii, a_ib, b_i):
    """``(u, W, fail)``: u = A_ii^-1 b_i and W = A_ii^-1 A_iB from ONE
    factorization per part (b_i packed beside A_iB as a multi-RHS solve),
    so that d_i = u - W d_B needs no third solve."""
    sol, fail = spd_solve_multi_batched(a_ii, torch.cat([b_i[..., None], a_ib], dim=-1))
    return sol[..., 0], sol[..., 1:], fail


class BlockSchurSolver:
    """Partitioned-Schur LM solver for one coupled topology on one device.

    ``n_parts`` sets the dissection (interiors of about ``n_vars/n_parts``
    variables, factored as one batch); ``part_of_var`` overrides the
    contiguous partition with an explicit variable -> part map. Solves on
    the card unless ``device`` names another.

    Two distance sketches coupled by a ``ScalarEqual`` across the cut:

    >>> import numpy as np
    >>> from ezpz_tpu_torch import Constraint, DatumPoint
    >>> from ezpz_tpu_torch.parallel import BlockSchurSolver
    >>> p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    >>> r, s = DatumPoint(4, 5), DatumPoint(6, 7)
    >>> cs = [Constraint.Fixed(0, 0.0), Constraint.Fixed(1, 0.0),
    ...       Constraint.Distance(p, q, 2.0),
    ...       Constraint.Fixed(4, 1.0), Constraint.Fixed(5, 0.0),
    ...       Constraint.Distance(r, s, 2.0),
    ...       Constraint.ScalarEqual(3, 7)]
    >>> out = BlockSchurSolver(cs, 8, n_parts=2, precision="f64",
    ...                        device="cpu").solve(
    ...     np.array([0.0, 0.0, 1.4, 1.5, 1.0, 0.0, 2.4, 1.6]))
    >>> out["converged"] and out["n_parts"] == 2 and out["n_boundary"] == 2
    True
    """

    def __init__(
        self,
        constraints: Sequence[Constraint],
        n_vars: int,
        n_parts: Optional[int] = None,
        part_of_var: Optional[np.ndarray] = None,
        weights: Optional[Sequence[float]] = None,
        config: Config = Config(),
        precision: str = "mixed",
        dtype: torch.dtype = torch.float64,
        boundary_solver: str = "dense",
        cg_tol: Optional[float] = None,
        cg_max_iters: int = 400,
        device=None,
    ):
        """``boundary_solver``: ``"dense"`` (Cholesky of the assembled
        (n_b, n_b) Schur complement), ``"cg"`` (Jacobi-preconditioned CG
        on the matrix-free Schur operator, to ``cg_tol`` relative to |rhs|:
        1e-5 in mixed, 1e-12 in f64 by default), ``"banded"`` (the exact
        band of half-bandwidth ``band_bw``, the widest within-part boundary
        span under the natural ordering; a hub-like topology makes it as
        wide as the boundary) or ``"auto"`` (``schur.resolve_boundary_solver``
        on the structure; the choice is readable back from
        ``self.boundary_solver``)."""
        if precision not in ("f64", "mixed"):
            raise ValueError(f"precision must be 'f64' or 'mixed', got {precision!r}")
        if boundary_solver not in ("dense", "cg", "banded", "auto"):
            raise ValueError(f"unknown boundary_solver {boundary_solver!r}")
        self.device = resolve_device(device)
        if cg_tol is None:
            cg_tol = 1e-5 if precision == "mixed" else 1e-12
        self.cg_tol = float(cg_tol)
        self.cg_max_iters = int(cg_max_iters)
        if n_parts is None and part_of_var is None:
            # Target interiors near the unrolled-Cholesky tier.
            n_parts = max(1, int(np.ceil(n_vars / 40)))
        if part_of_var is None:
            part_of_var = np.minimum(
                np.arange(n_vars) * n_parts // max(n_vars, 1), n_parts - 1
            )
        part_of_var = np.asarray(part_of_var)
        self.config = config
        self.precision = precision
        self.dtype = dtype
        self.jac_dtype = torch.float32 if precision == "mixed" else dtype
        self.n_vars = n_vars
        self.n_constraints = len(constraints)
        if weights is None:
            weights = [1.0] * len(constraints)

        # The solve-dtype system drives residuals, satisfaction and
        # degeneracy through the same code as solve_lm.
        self.system = compile_system(constraints, n_vars, weights, dtype)

        plan = plan_parts(constraints, n_vars, part_of_var, weights)
        self.P, self.m, self.kb, self.n_b = plan.P, plan.m, plan.kb, plan.n_b
        self.boundary = plan.boundary
        self.l2g, self.bmap, self.int_map = plan.l2g, plan.bmap, plan.int_map
        self.band_bw = plan.band_bw
        self.band_rows, self.band_off = plan.band_rows, plan.band_off
        self.imask = plan.imask
        self.boundary_solver = resolve_boundary_solver(
            boundary_solver, plan.n_b, plan.band_bw)

        # The parts as one system over the flattened local vector: residual
        # rows and flags in the solve dtype, Jacobians and the per-part
        # normal equations in jac_dtype, by the compiled system's own
        # evaluation and fixed-order assembly.
        self._local = part_system(plan, 0, plan.P, self.n_constraints, dtype)
        self._local_j = self._local.astype(self.jac_dtype)
        dev = self.device
        (self._l2g, self._bmap, self._int_src, self._int_dst,
         self._boundary) = part_index_tensors(plan, 0, plan.P, dev)
        self._imask = torch.as_tensor(plan.imask, dtype=self.jac_dtype, device=dev)
        self._seg_b, self._seg_band, self._seg_dense = part_segment_sums(
            plan, 0, plan.P, self.boundary_solver, dev)

    # -- the partitioned normal-equation pass -------------------------------

    def _partition_normal_eq(self, x: torch.Tensor):
        """Per-part ``(jtj (B, P, n_loc, n_loc), jtr (B, P, n_loc))`` in
        jac_dtype and the degenerate flags (B, n_constraints) at ``x`` (B,
        n_vars) in the solve dtype.

        Residual rows evaluate in the solve dtype at the true x (f32
        coordinates of magnitude c carry only ~6e-8*c, which caps the
        achievable residual far above 1e-8 on the 600-line coupled chain,
        whose coordinates reach 600); Jacobians evaluate in jac_dtype at
        the rounded point: the step only needs relative accuracy."""
        B = x.shape[0]
        x_ext = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        x_loc = x_ext[:, self._l2g]
        r_loc, deg = self._local.residual_and_flags(x_loc)
        _r, jtj, jtr, _deg = self._local_j.normal_equations(x_loc, rhs=r_loc)
        return jtj, jtr.reshape(B, self.P, self.m + self.kb), deg[:, : self.n_constraints]

    def _schur_step(self, x: torch.Tensor, lam: torch.Tensor):
        """One damped partitioned-Schur step at ``x`` (B, n_vars) with
        damping ``lam`` (B,). Returns ``(d (B, n_vars) in the solve dtype,
        fail (B,), deg_j (B, n_constraints))``."""
        jt = self.jac_dtype
        require_full_f32(x.device, jt, "BlockSchurSolver")
        B = x.shape[0]
        m, n_b = self.m, self.n_b
        jtj, jtr, deg_j = self._partition_normal_eq(x)
        # No f32 damping floor here (contrast solver.damped_spd_solve): big
        # coupled systems legitimately have softest-mode curvatures near
        # f32 round-off (a P-part chain's smallest JtJ eigenvalue scales
        # like 1/P^2 ~ 3e-6 at 600 parts), and flooring lambda there
        # measurably slows convergence (2 -> 11 LM iterations on the
        # 600-line coupled fixture, measured by the JAX package). A
        # genuinely singular interior just pays the reference's
        # reject-and-redamp cascade (newton.rs:96-99).
        lam_j = lam.to(jt)
        imask = self._imask
        a_ii, a_ib, a_bb, b_i, b_b = damped_blocks(jtj, jtr, lam_j, imask, m)

        if n_b:
            u, w_mat, fail_i = interior_solve(a_ii, a_ib, b_i)
            rhs_contrib = b_b - torch.einsum("bpmk,bpm->bpk", a_ib, u)
            rhs = self._seg_b(rhs_contrib.reshape(B, -1))
            if self.boundary_solver == "cg":
                d_b = self._cg_boundary(a_bb, a_ib, w_mat, lam_j, rhs)
                fail_b = torch.zeros((B,), dtype=torch.bool, device=x.device)
            elif self.boundary_solver == "banded":
                bw = self.band_bw
                s_contrib = a_bb - torch.einsum("bpmk,bpmj->bpkj", a_ib, w_mat)
                band = self._seg_band(s_contrib.reshape(B, -1)).reshape(B, n_b, bw + 1)
                band[:, :, bw] += lam_j[:, None]
                d_b, fail_b = banded_spd_solve(band, rhs)
            else:
                s_contrib = a_bb - torch.einsum("bpmk,bpmj->bpkj", a_ib, w_mat)
                s_mat = self._seg_dense(s_contrib.reshape(B, -1)).reshape(B, n_b, n_b)
                s_mat.diagonal(dim1=-2, dim2=-1).add_(lam_j[:, None])
                d_b, fail_b = spd_solve(s_mat, rhs)
            d_b_ext = torch.cat([d_b, torch.zeros_like(d_b[:, :1])], dim=1)
            d_b_loc = d_b_ext[:, self._bmap].reshape(B, self.P, self.kb)
            d_i = u - torch.einsum("bpmk,bpk->bpm", w_mat, d_b_loc)
        else:
            d_i, fail_i = spd_solve_batched(a_ii, b_i)
            fail_b = torch.zeros((B,), dtype=torch.bool, device=x.device)
            d_b = None
        fail = fail_i.any(dim=-1) | fail_b
        d_i = d_i * imask
        # The step back in global variable order: interior and boundary
        # slots are disjoint, so each lands once.
        d = torch.zeros((B, self.n_vars), dtype=self.dtype, device=x.device)
        d[:, self._int_dst] = d_i.reshape(B, -1)[:, self._int_src].to(self.dtype)
        if d_b is not None:
            d[:, self._boundary] = d_b.to(self.dtype)
        d = torch.where(fail[:, None], torch.zeros_like(d), d)
        return d, fail, deg_j

    def _cg_boundary(self, a_bb, a_ib, w_mat, lam_j, rhs):
        """The boundary step by Jacobi-PCG on the matrix-free Schur operator
        ``v -> sum_p (A_BB - A_pB^T W_p) v_p + lambda v``."""
        B, P, kb = rhs.shape[0], self.P, self.kb

        def s_matvec(v):
            v_ext = torch.cat([v, torch.zeros_like(v[:, :1])], dim=1)
            v_loc = v_ext[:, self._bmap].reshape(B, P, kb)
            t = torch.einsum("bpkj,bpj->bpk", a_bb, v_loc)
            t = t - torch.einsum("bpmk,bpm->bpk", a_ib,
                                 torch.einsum("bpmk,bpk->bpm", w_mat, v_loc))
            return self._seg_b(t.reshape(B, -1)) + lam_j[:, None] * v

        diag_local = (torch.diagonal(a_bb, dim1=-2, dim2=-1)
                      - torch.einsum("bpmk,bpmk->bpk", a_ib, w_mat))
        diag_s = self._seg_b(diag_local.reshape(B, -1)) + lam_j[:, None]
        minv = torch.where(diag_s > 0, 1.0 / diag_s, torch.ones_like(diag_s))
        tol = self.cg_tol * torch.sqrt(torch.sum(rhs * rhs, dim=-1))
        return _cg(s_matvec, rhs, None, tol, self.cg_max_iters, minv)

    # -- public solve ---------------------------------------------------------

    def solve_batch(self, x0s):
        """Solve a fleet of same-topology coupled systems from ``x0s`` (B,
        n_vars). Returns ``(LMResult, satisfied (B, n_constraints))``, all
        (B, ...) tensors on the solver's device; one host sync per LM trip."""
        c = self.config
        dev = self.device
        x0 = torch.as_tensor(x0s, dtype=torch.float64, device=dev)
        state = _init_state(self.system, x0, c.initial_lambda, lam_dtype=self.jac_dtype)
        final, res_conv = _lm_while_loop(
            state, self.system.residual_and_flags,
            lambda s, _live: self._schur_step(s.x, s.lam), c.max_iterations,
            torch.as_tensor(c.residual_tolerance, dtype=self.dtype, device=dev),
            torch.as_tensor(c.step_tolerance, dtype=self.dtype, device=dev),
            boundary_parity=True)
        res: LMResult = _reference_result(final, res_conv, c.max_iterations)
        return res, self.system.constraint_satisfaction(res.x)

    def solve(self, x0) -> dict:
        """Solve one system from ``x0`` (n_vars,): the JAX package's outcome
        dict (``x``, ``iterations``, ``converged``, ``satisfied``,
        ``degenerate``, ``n_boundary``, ``n_interior``, ``n_parts``) in
        numpy and Python values, from one device-to-host copy."""
        x0 = torch.as_tensor(x0, dtype=torch.float64, device=self.device)
        res, sat = self.solve_batch(x0[None])
        packed = pack_result(res.x[0], sat[0], res.deg[0], res.converged[0],
                             res.iterations[0]).cpu().numpy()
        x, sat, deg, converged, iterations = unpack_solver_result(
            packed, self.n_vars, self.n_constraints)
        return dict(x=x, iterations=iterations, converged=converged,
                    satisfied=sat, degenerate=deg, n_boundary=self.n_b,
                    n_interior=self.m, n_parts=self.P)
