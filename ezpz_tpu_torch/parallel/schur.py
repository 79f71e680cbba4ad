"""Sharded single-system solve by Schur-complement reduction.

The PyTorch counterpart of ``ezpz_tpu/parallel/schur.py``. One coupled
system's variables are partitioned over the ranks of a process group
(``parallel.dist``): each rank owns an interior, and the few variables
that a constraint spanning two ranks touches form a boundary B that every
rank holds. Each LM step solves the damped normal equations

    A = [[A_II, A_IB],    A_II block-diagonal over the ranks (interiors),
         [A_BI, A_BB]]    B replicated

with a Schur complement:

    per rank i:  W_i = A_ii^-1 A_iB,  u_i = A_ii^-1 b_i
    S    = psum(A_BB_i - A_iB^T W_i) + lambda I
    x_B  = S^-1 psum(b_B_i - A_iB^T u_i)          (solved on every rank)
    x_i  = u_i - W_i x_B                          (local)

Every ``psum`` is one ``all_reduce`` of one packed tensor, exactly where
the JAX solver has one: per LM trip, the trial evaluation's sum (the
residual's |r|^2 with the failure flag, and the max |r| and max |step| as
one-hot slots: no separate max), and the Schur matrix with its right-hand
side as an extra row (``boundary_solver="dense"``) or the right-hand side
and one (n_b,) sum per CG matvec (``"cg"``); one more at the start, and one
``all_gather`` of the interiors and flags at the end, so that every rank
returns the same outcome. Accept/reject and convergence read only summed
values, so every rank takes the same branch; the loop's condition is one
host sync per trip.

Residuals, norms and accept/reject run in f64; ``precision="mixed"``
drops the Jacobians, the normal equations, the Schur reduction and the
factorizations to f32 (a solve on a card then needs full f32 matrix
products and raises under TF32). ``solve_checkpointed`` runs the loop in
segments and saves the LM state after each (rank 0 writes, every rank
reads on resume; ``checkpoint.py``).

Also here: ``partition_variables`` and ``resolve_boundary_solver``, the
host-side helpers that every Schur solver shares.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import LM_LAMBDA_DECR, LM_LAMBDA_INCR, Config
from ..constraints import Constraint
from ..models.compiled import CompiledSystem, KindBlock
from ..ops.kernels import KERNELS
from ..ops.linalg import spd_solve, spd_solve_multi
from ..solver import _cg, _rows_max_abs
from .dist import Comm


def require_full_f32(device: torch.device, jac_dtype: torch.dtype, who: str) -> None:
    """Raise when an f32 solve on a card would run its matrix products in
    TF32: three decimal digits keep mixed precision from reaching the
    1e-8 residual (the JAX package sets matmul precision "highest")."""
    if (device.type == "cuda" and jac_dtype == torch.float32
            and torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            f"{who} needs full float32 matrix products on the GPU: TF32 (three "
            f"decimal digits) keeps mixed precision from reaching the 1e-8 "
            f"residual; call torch.set_float32_matmul_precision('highest')")


def resolve_boundary_solver(requested: str, n_b: int, band_bw: int,
                            banded_ok: bool = True) -> str:
    """Resolve ``boundary_solver="auto"`` from the coupling structure, all
    known at build time (the JAX package's rule):

    * ``banded`` when the Schur complement's half-bandwidth is a small
      fraction of ``n_b`` (chain-like coupling: ``4*(bw+1) <= n_b``): an
      exact direct solve in O(n_b*bw^2); only where the solver has a banded
      path (``banded_ok``);
    * ``dense`` for small boundaries (``n_b <= 256``): one Cholesky of a
      small matrix, the step exact;
    * ``cg`` otherwise: Jacobi-PCG matvecs never materialise S; the LM
      accept/reject loop absorbs the inexact step.
    """
    if requested != "auto":
        return requested
    if banded_ok and n_b > 0 and band_bw > 0 and 4 * (band_bw + 1) <= n_b:
        return "banded"
    if n_b <= 256:
        return "dense"
    return "cg"


def partition_variables(
    constraints: Sequence[Constraint], n_vars: int, n_devices: int,
    block_of_var: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, List[int]]:
    """Home part per variable (contiguous ranges by default) and the
    boundary set: every variable touched by a constraint spanning parts."""
    if block_of_var is None:
        block_of_var = np.minimum(
            np.arange(n_vars) * n_devices // max(n_vars, 1), n_devices - 1
        )
    block_of_var = np.asarray(block_of_var)
    boundary: set = set()
    for c in constraints:
        ids = c.dependent_variable_ids()
        homes = {int(block_of_var[v]) for v in ids}
        if len(homes) > 1:
            boundary.update(ids)
    return block_of_var, sorted(boundary)


# ---------------------------------------------------------------------------
# Partitioning and the per-rank systems


@dataclass
class ShardedLayout:
    n_vars: int
    n_devices: int
    interior: List[List[int]]  # per rank, global ids (unpadded)
    boundary: List[int]  # global ids, replicated
    n_i: int  # padded interior size
    n_b: int
    # per rank: local slot -> global id (padded slots map to -1)
    local_to_global: np.ndarray  # (D, n_i + n_b)


@dataclass
class _StackedBlock:
    spec: object
    idx: np.ndarray  # (D, n, k) int32 local indices
    par: np.ndarray  # (D, n, p)
    weight: np.ndarray  # (D, n)
    cid: np.ndarray  # (D, n) local constraint slot (dummy -> n_cons_max)


class ShardedSchurSolver:
    """Shard ONE coupled system's variables over the ranks of a process
    group; each LM step solves interiors locally and reduces the coupling
    through a Schur complement. With no group up it is a world of one.

    Two fixed-base distance sketches coupled by a ``ScalarEqual``:

    >>> import numpy as np
    >>> from ezpz_tpu_torch import Constraint, DatumPoint
    >>> from ezpz_tpu_torch.parallel import ShardedSchurSolver
    >>> p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    >>> r, s = DatumPoint(4, 5), DatumPoint(6, 7)
    >>> cs = [Constraint.Fixed(0, 0.0), Constraint.Fixed(1, 0.0),
    ...       Constraint.Distance(p, q, 2.0),
    ...       Constraint.Fixed(4, 1.0), Constraint.Fixed(5, 0.0),
    ...       Constraint.Distance(r, s, 2.0),
    ...       Constraint.ScalarEqual(3, 7)]
    >>> out = ShardedSchurSolver(cs, 8, device="cpu").solve(
    ...     np.array([0.0, 0.0, 1.4, 1.5, 1.0, 0.0, 2.4, 1.6]))
    >>> out["converged"] and bool(out["satisfied"].all())
    True
    """

    def __init__(
        self,
        constraints: Sequence[Constraint],
        n_vars: int,
        group=None,
        weights: Optional[Sequence[float]] = None,
        config: Config = Config(),
        block_of_var: Optional[np.ndarray] = None,
        dtype: torch.dtype = torch.float64,
        precision: str = "f64",
        boundary_solver: str = "dense",
        cg_tol: Optional[float] = None,
        cg_max_iters: int = 400,
        device=None,
    ):
        """``group``: the process group whose ranks share the system (the
        JAX solver's mesh; default the whole world). ``device``: this
        rank's device (``dist.rank_device``).

        ``precision="mixed"``: residuals, norms and accept/reject in f64;
        Jacobians, normal-equation blocks, the Schur reduction and every
        factorization in f32 (inexact Newton, verified in f64).

        ``boundary_solver``: ``"dense"`` (sum the (n_b, n_b) Schur matrix,
        Cholesky on every rank), ``"cg"`` (matrix-free CG: one (n_b,) sum
        per matvec, to ``cg_tol`` relative to |rhs|: 1e-12 when the linear
        algebra is f64, 1e-5 in f32) or ``"auto"`` (dense up to 256
        boundary variables, else CG; this solver has no banded path)."""
        if precision not in ("f64", "mixed"):
            raise ValueError(f"precision must be 'f64' or 'mixed', got {precision!r}")
        if boundary_solver not in ("dense", "cg", "auto"):
            raise ValueError(f"unknown boundary_solver {boundary_solver!r}")
        if cg_tol is None:
            cg_tol = 1e-5 if precision == "mixed" else 1e-12
        self.cg_tol = float(cg_tol)
        self.cg_max_iters = int(cg_max_iters)
        self.comm = comm = Comm(device, group)
        self.device = comm.device
        D = comm.size
        self.config = config
        self.dtype = dtype
        self.precision = precision
        # dtype of the linear-algebra side (J, JtJ, Schur, factorizations).
        self.jac_dtype = torch.float32 if precision == "mixed" else dtype
        self.n_vars = n_vars
        self.n_constraints = len(constraints)
        if weights is None:
            weights = [1.0] * len(constraints)

        block_of_var, boundary = partition_variables(
            constraints, n_vars, D, block_of_var
        )
        bset = set(boundary)
        interior: List[List[int]] = [[] for _ in range(D)]
        for v in range(n_vars):
            if v not in bset:
                interior[int(block_of_var[v])].append(v)
        n_i = max((len(iv) for iv in interior), default=0)
        n_b = len(boundary)
        self.n_i, self.n_b = n_i, n_b
        self.boundary_solver = resolve_boundary_solver(
            boundary_solver, n_b, 0, banded_ok=False
        )

        # Local index maps.
        local_to_global = -np.ones((D, n_i + n_b), dtype=np.int64)
        global_to_local = [dict() for _ in range(D)]
        for d in range(D):
            for i, g in enumerate(interior[d]):
                local_to_global[d, i] = g
                global_to_local[d][g] = i
            for j, g in enumerate(boundary):
                local_to_global[d, n_i + j] = g
                global_to_local[d][g] = n_i + j
        self.layout = ShardedLayout(
            n_vars=n_vars, n_devices=D, interior=interior, boundary=boundary,
            n_i=n_i, n_b=n_b, local_to_global=local_to_global,
        )

        # Home each constraint: local constraints to their variables' rank,
        # coupling constraints round-robin.
        per_device: List[List[int]] = [[] for _ in range(D)]
        rr = 0
        for cid, c in enumerate(constraints):
            homes = {int(block_of_var[v]) for v in c.dependent_variable_ids()}
            if len(homes) == 1:
                per_device[homes.pop()].append(cid)
            else:
                per_device[rr % D].append(cid)
                rr += 1

        n_cons_max = max((len(p) for p in per_device), default=0)
        self.n_cons_max = n_cons_max
        # Map (rank, local constraint slot) -> global cid (-1 for padding).
        self.cons_map = -np.ones((D, n_cons_max), dtype=np.int64)
        for d in range(D):
            for s, cid in enumerate(per_device[d]):
                self.cons_map[d, s] = cid

        # Lower per rank, grouped by kind, stacked over the ranks and padded
        # to uniform counts (the JAX solver's arrays: they feed the
        # checkpoint's fingerprint).
        per_dev_kinds: List[Dict[str, dict]] = []
        for d in range(D):
            slots: Dict[str, dict] = {}
            for s, cid in enumerate(per_device[d]):
                for inst in constraints[cid].lower():
                    kslot = slots.setdefault(
                        inst.kernel, {"idx": [], "par": [], "w": [], "cid": []}
                    )
                    kslot["idx"].append(
                        tuple(global_to_local[d][v] for v in inst.var_ids)
                    )
                    kslot["par"].append(inst.params)
                    kslot["w"].append(weights[cid])
                    kslot["cid"].append(s)
            per_dev_kinds.append(slots)

        self.blocks: List[_StackedBlock] = []
        for kind in sorted({k for slots in per_dev_kinds for k in slots}):
            spec = KERNELS[kind]
            n_max = max(len(per_dev_kinds[d].get(kind, {"idx": []})["idx"])
                        for d in range(D))
            idx = np.zeros((D, n_max, spec.nvars), dtype=np.int32)
            par = np.zeros((D, n_max, spec.nparams), dtype=np.float64)
            wgt = np.zeros((D, n_max), dtype=np.float64)  # dummies weight 0
            cid = np.full((D, n_max), n_cons_max, dtype=np.int32)  # dummy slot
            for d in range(D):
                kslot = per_dev_kinds[d].get(kind)
                if not kslot:
                    continue
                n = len(kslot["idx"])
                idx[d, :n] = np.asarray(kslot["idx"], dtype=np.int32)
                par[d, :n] = np.asarray(kslot["par"], dtype=np.float64).reshape(
                    n, spec.nparams)
                wgt[d, :n] = kslot["w"]
                cid[d, :n] = kslot["cid"]
            self.blocks.append(_StackedBlock(spec, idx, par, wgt, cid))

        # Padded-interior mask: 1.0 on real slots, 0.0 on padding.
        self.interior_mask = np.zeros((D, n_i), dtype=np.float64)
        for d in range(D):
            self.interior_mask[d, : len(interior[d])] = 1.0

        # This rank's constraints as one system over its local vector
        # (interior, then boundary), padding dropped. A weight-0 instance
        # lands in the dummy slot: as in the JAX solver, it neither flags
        # degenerate nor can be unsatisfied.
        r = comm.rank
        own = []
        for b in self.blocks:
            n = int(np.sum(b.cid[r] < n_cons_max))
            if n:
                w = b.weight[r, :n]
                own.append(KindBlock(spec=b.spec, idx=b.idx[r, :n], par=b.par[r, :n],
                                     weight=w, cid=np.where(w > 0, b.cid[r, :n], n_cons_max)))
        self._sys = CompiledSystem(
            n_vars=n_i + n_b, n_constraints=n_cons_max + 1,
            n_rows=sum(int(b.idx.shape[0]) * b.spec.dim for b in own),
            blocks=tuple(own)).astype(dtype)
        self._sys_j = self._sys.astype(self.jac_dtype)
        dev = self.device
        jt = self.jac_dtype
        self._imask = torch.as_tensor(self.interior_mask[r], dtype=dtype, device=dev)
        self._imask_j = self._imask.to(jt)
        self._eye_i = torch.eye(n_i, dtype=jt, device=dev)
        self._eye_b = torch.eye(n_b, dtype=jt, device=dev)
        self._pad_diag = (1.0 - self._imask_j) * self._eye_i  # unit diagonal on padding
        self.lm_trips = 0
        self.cg_trips = 0

    # -- one rank's evaluation over its local x -----------------------------

    def _eval(self, xl: torch.Tensor):
        """(|r|^2, max|r|, degenerate flags (n_cons_max + 1,), weighted rows
        (1, n_rows)) of this rank's constraints at local ``xl``, in the
        solve dtype (no collective)."""
        r, deg = self._sys.residual_and_flags(xl[None])
        return torch.sum(r * r), _rows_max_abs(r)[0], deg[0], r

    def _global_eval(self, xl, fail_local=None, step_local=None):
        """The trial evaluation: ONE packed sum carries |r|^2 and the
        failure flag, and (one-hot slots, max after the sum) max|r| and
        max|step|. Returns (r2, fail, rinf, step_inf, local degenerate
        flags)."""
        comm = self.comm
        r2, rinf, deg, _r = self._eval(xl)
        zero = torch.zeros((), dtype=self.dtype, device=xl.device)
        fl = zero if fail_local is None else fail_local
        sl = zero if step_local is None else step_local
        packed = comm.psum(torch.cat([torch.stack([r2, fl]), comm.onehot(rinf),
                                      comm.onehot(sl)]))
        D = comm.size
        return (packed[0], packed[1] > 0, torch.max(packed[2:2 + D]),
                torch.max(packed[2 + D:]), deg)

    def _schur_step(self, xl, lam):
        """The damped step at local ``xl``: ``(d_i (n_i,), d_b (n_b,)`` in
        the solve dtype, the local failure flag and max|step| as solve-dtype
        scalars, the Jacobian pass's degenerate flags)."""
        comm = self.comm
        n_i, n_b = self.n_i, self.n_b
        jt = self.jac_dtype
        _r2, _ri, deg_j, r = self._eval(xl)
        if jt == self.dtype:
            _r, jtj, jtr, _d = self._sys.normal_equations(xl[None])
        else:
            # Residual rows in f64 at the true point, Jacobian in f32.
            _r, jtj, jtr, _d = self._sys_j.normal_equations(xl[None], rhs=r)
        jtj, jtr = jtj[0], jtr[0]
        # No f32 damping floor (see block_schur.py).
        lam_j = lam.to(jt)
        b_i = -jtr[:n_i]
        b_b = -jtr[n_i:]
        a_ii = jtj[:n_i, :n_i] + lam_j * self._eye_i * self._imask_j[None, :] + self._pad_diag
        a_ib = jtj[:n_i, n_i:]
        a_bb_part = jtj[n_i:, n_i:]
        false = torch.zeros((), dtype=torch.bool, device=xl.device)
        if n_b:
            # ONE interior factorization: b_i rides beside A_iB, and the
            # back-substitution is d_i = u - W d_b.
            sol, fail_i = spd_solve_multi(a_ii[None], torch.cat([b_i[:, None], a_ib], 1)[None])
            sol, fail_i = sol[0], fail_i[0]
            u, w_mat = sol[:, 0], sol[:, 1:]
            rhs_part = b_b - a_ib.T @ u
            if self.boundary_solver == "cg":
                rhs = comm.psum(rhs_part)

                def s_matvec(v):
                    local = a_bb_part @ v[0] - a_ib.T @ (w_mat @ v[0])
                    return comm.psum(local)[None] + lam_j * v

                before = comm.collectives
                tol = self.cg_tol * torch.sqrt(torch.dot(rhs, rhs))
                d_b = _cg(s_matvec, rhs[None], torch.zeros_like(rhs)[None], tol[None],
                          self.cg_max_iters)[0]
                # r0 = b - S 0 is one matvec; each trip one more, each trip
                # and the last check one host sync.
                matvecs = comm.collectives - before
                self.cg_trips += matvecs - 1
                comm.host_syncs += matvecs
                fail_b = false
            else:
                # ONE sum for the Schur matrix and its rhs (an extra row).
                packed = comm.psum(torch.cat([a_bb_part - a_ib.T @ w_mat, rhs_part[None]], 0))
                s_mat = packed[:n_b] + lam_j * self._eye_b
                d_b, fail_b = spd_solve(s_mat[None], packed[n_b][None])
                d_b, fail_b = d_b[0], fail_b[0]
            d_i = u - w_mat @ d_b
            step_inf_b = torch.max(torch.abs(d_b))
        else:
            d_i, fail_i = spd_solve(a_ii[None], b_i[None])
            d_i, fail_i = d_i[0], fail_i[0]
            d_b = torch.zeros((0,), dtype=jt, device=xl.device)
            fail_b = false
            step_inf_b = torch.zeros((), dtype=jt, device=xl.device)
        d_i = d_i.to(self.dtype) * self._imask
        d_b = d_b.to(self.dtype)
        step_inf_i = (torch.max(torch.abs(d_i)) if n_i
                      else torch.zeros((), dtype=self.dtype, device=xl.device))
        fail_local = (fail_i | fail_b).to(self.dtype)
        step_local = torch.maximum(step_inf_i, step_inf_b.to(self.dtype))
        return d_i, d_b, fail_local, step_local, deg_j

    def _run(self, x_i, x_b, lam0, it0, deg0, it_limit):
        """The LM loop on this rank from local ``x_i`` and the replicated
        ``x_b``, starting at iteration ``it0`` with degenerate flags
        ``deg0`` (this rank's slots), up to ``it_limit`` (a segment of a
        checkpointed solve stops there)."""
        comm = self.comm
        c = self.config
        rtol, stol = c.residual_tolerance, c.step_tolerance
        r2, _f, rinf, _s, deg = self._global_eval(torch.cat([x_i, x_b]))
        deg = deg | deg0
        lam = torch.as_tensor(lam0, dtype=self.dtype, device=x_i.device)
        it = int(it0)
        false = torch.zeros((), dtype=torch.bool, device=x_i.device)
        done, converged = false, false
        iterations = torch.zeros((), dtype=torch.int64, device=x_i.device)
        # Residual check in the condition: a residual-converged solve pays
        # no detection pass of the body.
        while it < it_limit and comm.read(~done & (rinf > rtol)):
            d_i, d_b, fail_local, step_local, deg_j = self._schur_step(
                torch.cat([x_i, x_b]), lam)
            # The (fail, step-inf) reduction rides in the trial evaluation's
            # sum; a failed factorization's step is zero-filled, and d_b
            # comes from summed data, so the trial point is the same on
            # every rank before the summed flag is known.
            x_i_new, x_b_new = x_i + d_i, x_b + d_b
            r2_new, fail, rinf_new, step_inf, deg_r = self._global_eval(
                torch.cat([x_i_new, x_b_new]), fail_local, step_local)
            accept = ~fail & (r2_new < r2)
            x_i = torch.where(accept, x_i_new, x_i)
            x_b = torch.where(accept, x_b_new, x_b)
            r2 = torch.where(accept, r2_new, r2)
            rinf = torch.where(accept, rinf_new, rinf)
            lam = torch.where(accept, lam * LM_LAMBDA_DECR, lam * LM_LAMBDA_INCR)
            deg = deg | deg_j | deg_r
            step_conv = ~fail & (step_inf <= stol)
            done = step_conv
            converged = converged | step_conv
            iterations = torch.where(step_conv, it, iterations)
            it += 1
            self.lm_trips += 1
        res_conv = rinf <= rtol
        converged = converged | res_conv
        # An exhausted budget reports the limit in force (a segment's).
        iterations = torch.where(done, iterations,
                                 torch.where(res_conv, it, int(it_limit)))
        # Satisfaction is judged per rank over its own constraints: no
        # collective.
        sat = self._sys.constraint_satisfaction(torch.cat([x_i, x_b])[None])[0]
        return x_i, x_b, iterations, converged, deg, sat, lam, it, done | res_conv

    def _scatter_x(self, x0) -> Tuple[np.ndarray, np.ndarray]:
        D = self.layout.n_devices
        x0 = np.asarray(x0, dtype=np.float64)
        x_i0 = np.zeros((D, self.n_i))
        for d in range(D):
            ids = self.layout.interior[d]
            x_i0[d, : len(ids)] = x0[ids]
        x_b0 = (np.asarray([x0[g] for g in self.layout.boundary], dtype=np.float64)
                if self.n_b else np.zeros((0,)))
        return x_i0, x_b0

    def _gather_x(self, x0, x_i, x_b) -> np.ndarray:
        x_out = np.array(x0, dtype=np.float64)
        for d in range(self.layout.n_devices):
            ids = self.layout.interior[d]
            x_out[ids] = x_i[d, : len(ids)]
        x_out[self.layout.boundary] = x_b
        return x_out

    def _outcome(self, x_out, iterations, converged, deg, sat):
        satisfied = np.ones(self.n_constraints, dtype=bool)
        degenerate = np.zeros(self.n_constraints, dtype=bool)
        for d in range(self.layout.n_devices):
            for s_, cid in enumerate(self.cons_map[d]):
                if cid >= 0:
                    satisfied[cid] = sat[d, s_]
                    degenerate[cid] = deg[d, s_]
        return dict(
            x=x_out,
            iterations=int(iterations),
            converged=bool(converged),
            satisfied=satisfied,
            degenerate=degenerate,
            n_boundary=self.n_b,
            n_interior=self.n_i,
        )

    def _run_segment(self, x_i0, x_b0, lam0, it0, deg0, it_limit):
        """One segment of the LM loop from host state: ``x_i0`` (D, n_i),
        ``x_b0`` (n_b,), ``deg0`` (D, n_cons_max + 1), as the JAX solver
        takes them. Returns host values, the same on every rank: ``(x_i
        (D, n_i), x_b, iterations, converged, deg (D, n_slots), sat (D,
        n_slots), lam, it, finished)``, the per-rank rows by one
        ``all_gather``."""
        require_full_f32(self.device, self.jac_dtype, "ShardedSchurSolver")
        r, dev, dt = self.comm.rank, self.device, self.dtype
        x_i, x_b, iterations, converged, deg, sat, lam, it, finished = self._run(
            torch.as_tensor(np.asarray(x_i0)[r], dtype=dt, device=dev),
            torch.as_tensor(np.asarray(x_b0), dtype=dt, device=dev), lam0, it0,
            torch.as_tensor(np.asarray(deg0)[r], dtype=torch.bool, device=dev), it_limit)
        rows = self.comm.gather(torch.cat([x_i, deg.to(dt), sat.to(dt)])).cpu().numpy()
        scalars = torch.cat([x_b, torch.stack([iterations.to(dt), converged.to(dt), lam,
                                               finished.to(dt)])]).cpu().numpy()
        self.comm.host_syncs += 1
        n_i, n_s = self.n_i, self.n_cons_max + 1
        n_b = self.n_b
        return (rows[:, :n_i], scalars[:n_b], int(scalars[n_b]), bool(scalars[n_b + 1]),
                rows[:, n_i:n_i + n_s] != 0, rows[:, n_i + n_s:] != 0,
                float(scalars[n_b + 2]), it, bool(scalars[n_b + 3]))

    def _reset_counts(self) -> None:
        self.comm.reset()
        self.lm_trips = 0
        self.cg_trips = 0

    def counts(self) -> dict:
        """Counters of the last solve: collectives and their bytes, host
        syncs, LM trips (steps taken) and CG trips."""
        return self.comm.counts(lm_trips=self.lm_trips, cg_trips=self.cg_trips)

    def solve(self, x0: np.ndarray) -> dict:
        """Solve from ``x0`` (n_vars,), the same on every rank. Returns the
        JAX solver's outcome dict (``x``, ``iterations``, ``converged``,
        ``satisfied``, ``degenerate``, ``n_boundary``, ``n_interior``) in
        numpy and Python values, the same on every rank."""
        self._reset_counts()
        c = self.config
        x_i0, x_b0 = self._scatter_x(x0)
        deg0 = np.zeros((self.layout.n_devices, self.n_cons_max + 1), dtype=bool)
        x_i, x_b, iterations, converged, deg, sat, _lam, _it, _fin = self._run_segment(
            x_i0, x_b0, c.initial_lambda, 0, deg0, c.max_iterations)
        return self._outcome(self._gather_x(x0, x_i, x_b), iterations, converged, deg, sat)

    def fingerprint(self, x0: np.ndarray) -> str:
        """The checkpoint key of a solve from ``x0``: the layout, the
        parameters and weights, the configuration and ``x0`` (the JAX
        solver's arrays, so the same solve has the same key there)."""
        from ..checkpoint import topology_fingerprint

        c = self.config
        return topology_fingerprint(
            self.cons_map,
            self.layout.local_to_global,
            *[b.par for b in self.blocks],
            *[b.weight for b in self.blocks],
            np.asarray([c.max_iterations, c.residual_tolerance,
                        c.step_tolerance, c.initial_lambda], np.float64),
            np.asarray(x0, np.float64),
        )

    def solve_checkpointed(self, x0: np.ndarray, checkpoint_path: str,
                           checkpoint_every: int = 5):
        """Segmented solve with host-side checkpoint/resume.

        Runs the LM loop ``checkpoint_every`` iterations at a time; after
        each segment rank 0 saves (x, lambda, iteration, degenerate flags)
        to ``checkpoint_path`` and every rank waits at a barrier. If the
        file already holds the SAME solve (same topology, parameters,
        weights, configuration and ``x0``: ``fingerprint``), every rank
        resumes from it instead of starting over; any mismatch starts
        fresh. A finished solve removes the file, so re-running it starts
        fresh and reports the same iterations."""
        from ..checkpoint import load_state, save_state

        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
        self._reset_counts()
        c = self.config
        fp = self.fingerprint(x0)
        state = load_state(checkpoint_path, fp)
        if state is None:
            x_i, x_b = self._scatter_x(x0)
            lam = float(c.initial_lambda)
            it = 0
            deg = np.zeros((self.layout.n_devices, self.n_cons_max + 1), dtype=bool)
        else:
            x_i, x_b, lam, it, deg = state

        while True:
            limit = min(it + checkpoint_every, c.max_iterations)
            (x_i, x_b, iterations, converged, deg, sat, lam, it,
             finished) = self._run_segment(x_i, x_b, lam, it, deg, limit)
            if self.comm.rank == 0:
                save_state(checkpoint_path, fp, x_i, x_b, lam, it, deg)
            self.comm.barrier()
            if finished or it >= c.max_iterations:
                break

        if self.comm.rank == 0:
            try:
                os.remove(checkpoint_path)
            except OSError:
                pass
        self.comm.barrier()
        return self._outcome(self._gather_x(x0, x_i, x_b), iterations, converged, deg, sat)
