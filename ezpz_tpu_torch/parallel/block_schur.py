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

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..constraints import Constraint
from ..models.compiled import CompiledSystem, KindBlock, compile_system, gather_sum
from ..ops.banded import banded_spd_solve
from ..ops.kernels import KERNELS
from ..ops.linalg import spd_solve, spd_solve_batched, spd_solve_multi_batched
from ..solver import (LMResult, _init_state, _lm_while_loop, _reference_result,
                      pack_result, resolve_device, unpack_solver_result)
from .hier import _pcg
from .schur import partition_variables, resolve_boundary_solver


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
        P = int(part_of_var.max()) + 1 if n_vars else 1
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

        _pv, boundary = partition_variables(constraints, n_vars, P, part_of_var)
        bset = set(boundary)
        self.boundary = boundary
        self.n_b = n_b = len(boundary)
        b_slot = {g: j for j, g in enumerate(boundary)}
        interior: List[List[int]] = [
            [v for v in range(n_vars) if part_of_var[v] == p and v not in bset]
            for p in range(P)
        ]
        self.P = P
        m = max((len(iv) for iv in interior), default=0)
        self.m = m

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
        self.kb = kb
        n_loc = m + kb

        # l2g gathers x per part (dummy slot n_vars reads an appended zero);
        # bmap sends each part's boundary entries to the global boundary
        # (dummy slot n_b is dropped); int_map sends interior steps out.
        l2g = np.full((P, n_loc), n_vars, dtype=np.int32)
        g2l = [dict() for _ in range(P)]
        bmap = np.full((P, kb), n_b, dtype=np.int32)
        int_map = np.full((P, m), n_vars, dtype=np.int32)
        for p in range(P):
            for i, g in enumerate(interior[p]):
                l2g[p, i] = g
                g2l[p][g] = i
                int_map[p, i] = g
            for j, g in enumerate(local_b[p]):
                l2g[p, m + j] = g
                g2l[p][g] = m + j
                bmap[p, j] = b_slot[g]
        self.l2g = l2g
        self.bmap = bmap
        self.int_map = int_map

        # The band: half-bandwidth = widest within-part boundary span under
        # the natural ordering (a part's Schur block couples only its own
        # boundary slots, so the lower band captures S exactly). Each
        # (part, k, j) block entry maps to (row slot, band offset); upper-
        # triangle and dummy entries get out-of-range offsets (dropped).
        spans = [
            int(r.max() - r.min())
            for p in range(P)
            for r in (bmap[p][bmap[p] < n_b],)
            if r.size
        ]
        self.band_bw = bw = max(spans, default=0)
        rows = np.repeat(bmap[:, :, None], kb, axis=2)
        cols = np.repeat(bmap[:, None, :], kb, axis=1)
        off = cols - rows + bw
        invalid = (rows >= n_b) | (cols >= n_b) | (off < 0) | (off > bw)
        self.band_rows = np.where(invalid, n_b, rows)
        self.band_off = np.where(invalid, bw + 1, off)
        self.boundary_solver = resolve_boundary_solver(boundary_solver, n_b, bw)
        imask = np.zeros((P, m))
        for p in range(P):
            imask[p, : len(interior[p])] = 1.0
        self.imask = imask

        # The per-part kernel blocks with local indices, stacked over the
        # parts (padded instances: local slot 0, zero parameters and
        # weight, constraint id n_constraints).
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
            idx = np.zeros((P, n_max, spec.nvars), dtype=np.int32)
            par = np.zeros((P, n_max, spec.nparams), dtype=np.float64)
            wgt = np.zeros((P, n_max), dtype=np.float64)
            cid = np.full((P, n_max), self.n_constraints, dtype=np.int32)
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

        # The parts as one system over the flattened local vector (P parts
        # of n_loc variables, constraint slot n_constraints the padding's):
        # residual rows and flags in the solve dtype, Jacobians and the
        # per-part normal equations in jac_dtype, by the compiled system's
        # own evaluation and fixed-order assembly.
        offs = (np.arange(P, dtype=np.int32) * n_loc)[:, None, None]
        local = CompiledSystem(
            n_vars=P * n_loc, n_constraints=self.n_constraints + 1,
            n_rows=sum(idx.shape[0] * idx.shape[1] * spec.dim
                       for spec, idx, *_ in jblocks),
            blocks=tuple(
                KindBlock(spec=spec, idx=(idx + offs).reshape(wgt.size, spec.nvars),
                          par=par.reshape(wgt.size, spec.nparams),
                          weight=wgt.reshape(-1), cid=cid.reshape(-1))
                for spec, idx, par, wgt, cid in jblocks),
            part_size=n_loc,
        ).astype(dtype)
        self._local = local
        self._local_j = local.astype(self.jac_dtype)

        dev = self.device
        as_long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
        self._l2g = as_long(l2g.reshape(-1))
        self._bmap = as_long(bmap.reshape(-1))
        real = int_map.reshape(-1) < n_vars
        self._int_src = as_long(np.flatnonzero(real))
        self._int_dst = as_long(int_map.reshape(-1)[real])
        self._boundary = as_long(boundary)
        self._imask = torch.as_tensor(imask, dtype=self.jac_dtype, device=dev)
        self._seg_b = _SegmentSum(bmap, n_b, dev)
        if self.boundary_solver == "banded":
            self._seg_band = _SegmentSum(
                np.where(invalid, -1, rows * (bw + 1) + off), n_b * (bw + 1), dev)
        elif self.boundary_solver == "dense":
            self._seg_dense = _SegmentSum(
                np.where((rows >= n_b) | (cols >= n_b), -1, rows * n_b + cols),
                n_b * n_b, dev)

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
        if (x.is_cuda and jt == torch.float32
                and torch.get_float32_matmul_precision() != "highest"):
            raise RuntimeError(
                "BlockSchurSolver needs full float32 matrix products on the GPU: "
                "TF32 (three decimal digits) keeps mixed precision from reaching "
                "the 1e-8 residual; call torch.set_float32_matmul_precision('highest')")
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
        eye_m = torch.eye(m, dtype=jt, device=x.device)
        # Unit diagonal on padded interior slots keeps A_pp SPD.
        a_ii = (jtj[..., :m, :m]
                + lam_j[:, None, None, None] * eye_m * imask[:, None, :]
                + (1.0 - imask)[:, :, None] * eye_m)
        a_ib = jtj[..., :m, m:]  # (B, P, m, kb)
        a_bb = jtj[..., m:, m:]  # (B, P, kb, kb)
        b_i = -jtr[..., :m]
        b_b = -jtr[..., m:]

        if n_b:
            # One interior factorization per step: b_i packed beside A_ib,
            # so u = A_ii^-1 b_i and W = A_ii^-1 A_ib come out of one
            # multi-RHS solve, and d_i = u - W d_b needs no third solve.
            packed = torch.cat([b_i[..., None], a_ib], dim=-1)
            sol, fail_i = spd_solve_multi_batched(a_ii, packed)
            u = sol[..., 0]
            w_mat = sol[..., 1:]
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
        return _pcg(s_matvec, rhs, minv, tol, self.cg_max_iters)

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
