"""Two-level sharded Schur solve: coupled systems of many thousands of
variables over the ranks of a process group.

The PyTorch counterpart of ``ezpz_tpu/parallel/hier.py``. It composes the
two other Schur solvers: the variables split into P small parts (~tens of
variables), whose interiors factor as one batch on each rank as in
``BlockSchurSolver``, and the parts are dealt to the D ranks contiguously
(padded to D * Pl) as ``ShardedSchurSolver`` deals variables. The boundary
B is replicated; its damped Schur system is solved

* ``"cg"`` (default): by distributed Jacobi-preconditioned CG, each matvec
  one (n_b,) sum (``parallel.dist``), the Jacobi diagonal riding in the
  right-hand side's sum; the (n_b, n_b) matrix exists nowhere;
* ``"banded"``: as a band (chain-like couplings), one sum of the band with
  the right-hand side as an extra column, then the banded solve on every
  rank (``ops.banded.banded_spd_solve``: the hand-written kernel on a
  card);
* ``"dense"``: one sum of S with the right-hand side as an extra row, then
  a Cholesky on every rank;
* ``"auto"``: resolved on the structure (``schur.resolve_boundary_solver``).

Per LM trip: one sum for the step (every rank's interior steps in disjoint
slots, the failure flag in one more), one for the trial residual (|r|^2,
and max|r| in one-hot slots), and the boundary's; one more at the start,
and one max of the unsatisfied and degenerate flags at the end (the JAX
solver's ``pmax``). Per-rank memory is O(P/D (m + k_b)^2) for the normal
equations plus O(n_vars) of replicated state.

Semantics mirror ``solve_lm``: damped accept/reject with the reference's
lambda schedule, residual and step convergence, degenerate flags,
unweighted 1e-4 satisfaction. Residual rows evaluate in the solve dtype at
the true point; ``precision="mixed"`` drops the Jacobians, the normal
equations, the factorizations and CG to f32 (a solve on a card then needs
full f32 matrix products and raises under TF32). Every sum within a rank
is a fixed gather in a fixed order (``block_schur._SegmentSum``), so a
rank's arithmetic is the same from run to run.

The CG boundary is ``ezpz_tpu/parallel/hier.py``'s Jacobi-preconditioned
CG (``_pcg``), which is ``solver._cg`` with a preconditioner, shared with
``BlockSchurSolver(boundary_solver="cg")``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import LM_LAMBDA_DECR, LM_LAMBDA_INCR, Config
from ..constraints import Constraint
from ..ops.banded import banded_spd_solve
from ..ops.linalg import spd_solve, spd_solve_batched
from ..solver import _cg, _rows_max_abs
from .block_schur import (damped_blocks, interior_solve, part_index_tensors,
                          part_segment_sums, part_system, plan_parts)
from .dist import Comm
from .schur import require_full_f32, resolve_boundary_solver


class ShardedBlockSchurSolver:
    """Two-level partitioned-Schur LM solver over the ranks of a process
    group (a world of one with no group up).

    ``n_parts``/``part_of_var`` set the level-1 dissection as in
    ``BlockSchurSolver`` (default ``max(D, ceil(n_vars / 40))`` parts);
    parts are dealt to ranks contiguously and padded to a uniform count.

    >>> import numpy as np
    >>> from ezpz_tpu_torch import Constraint, DatumPoint
    >>> from ezpz_tpu_torch.parallel import ShardedBlockSchurSolver
    >>> p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    >>> r, s = DatumPoint(4, 5), DatumPoint(6, 7)
    >>> cs = [Constraint.Fixed(0, 0.0), Constraint.Fixed(1, 0.0),
    ...       Constraint.Distance(p, q, 2.0),
    ...       Constraint.Fixed(4, 1.0), Constraint.Fixed(5, 0.0),
    ...       Constraint.Distance(r, s, 2.0),
    ...       Constraint.ScalarEqual(3, 7)]
    >>> out = ShardedBlockSchurSolver(cs, 8, n_parts=2, device="cpu").solve(
    ...     np.array([0.0, 0.0, 1.4, 1.5, 1.0, 0.0, 2.4, 1.6]))
    >>> out["converged"] and out["n_boundary"] == 2
    True
    """

    def __init__(
        self,
        constraints: Sequence[Constraint],
        n_vars: int,
        n_parts: Optional[int] = None,
        part_of_var: Optional[np.ndarray] = None,
        group=None,
        weights: Optional[Sequence[float]] = None,
        config: Config = Config(),
        precision: str = "mixed",
        dtype: torch.dtype = torch.float64,
        boundary_solver: str = "cg",
        cg_tol: Optional[float] = None,
        cg_max_iters: int = 400,
        device=None,
    ):
        """``group``: the process group whose ranks share the system (the
        JAX solver's mesh; default the whole world). ``device``: this
        rank's device (``dist.rank_device``). ``cg_tol`` is relative to
        |rhs|: 1e-5 in mixed, 1e-12 in f64 by default."""
        if precision not in ("f64", "mixed"):
            raise ValueError(f"precision must be 'f64' or 'mixed', got {precision!r}")
        if boundary_solver not in ("dense", "cg", "banded", "auto"):
            raise ValueError(f"unknown boundary_solver {boundary_solver!r}")
        self.comm = comm = Comm(device, group)
        self.device = dev = comm.device
        D = self.D = comm.size
        if n_parts is None and part_of_var is None:
            n_parts = max(D, int(np.ceil(n_vars / 40)))
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
        if cg_tol is None:
            cg_tol = 1e-5 if precision == "mixed" else 1e-12
        self.cg_tol = float(cg_tol)
        self.cg_max_iters = int(cg_max_iters)
        self.n_vars = n_vars
        self.n_constraints = len(constraints)
        if weights is None:
            weights = [1.0] * len(constraints)

        # Pad the part axis to D * Pl; this rank holds parts lo:hi.
        Pl = (P + D - 1) // D
        plan = plan_parts(constraints, n_vars, part_of_var, weights, rows=D * Pl)
        self.P, self.Pl = P, Pl
        self.boundary = plan.boundary
        self.n_b, self.m, self.kb = plan.n_b, plan.m, plan.kb
        self.band_bw = plan.band_bw
        self.boundary_solver = resolve_boundary_solver(boundary_solver, plan.n_b,
                                                       plan.band_bw)

        def dev_shape(a):
            return a.reshape((D, Pl) + a.shape[1:])

        self.l2g = dev_shape(plan.l2g)
        self.bmap = dev_shape(plan.bmap)
        self.int_map = dev_shape(plan.int_map)
        self.imask = dev_shape(plan.imask)

        lo, hi = comm.rank * Pl, (comm.rank + 1) * Pl
        self._local = part_system(plan, lo, hi, self.n_constraints, dtype,
                                  unweighted_to_dummy=True)
        self._local_j = self._local.astype(self.jac_dtype)
        (self._l2g, self._bmap, self._int_src, self._int_dst,
         self._boundary) = part_index_tensors(plan, lo, hi, dev)
        self._imask = torch.as_tensor(plan.imask[lo:hi], dtype=self.jac_dtype, device=dev)
        self._seg_b, self._seg_band, self._seg_dense = part_segment_sums(
            plan, lo, hi, self.boundary_solver, dev)
        self.lm_trips = 0
        self.cg_trips = 0
        self.history: list = []

    # -- one rank's part of the LM loop ----------------------------------------

    def _stats(self, x: torch.Tensor):
        """This rank's parts at the replicated ``x`` (n_vars,): the local
        vectors (1, Pl * n_loc), the weighted rows (1, n_rows) and the
        degenerate flags (n_constraints + 1,), in the solve dtype."""
        x_loc = torch.cat([x, x.new_zeros(1)])[self._l2g][None]
        r, deg = self._local.residual_and_flags(x_loc)
        return x_loc, r, deg[0]

    def _global(self, r: torch.Tensor):
        """(|r|^2, max|r|) over every rank: ONE sum, max|r| in one-hot
        slots."""
        rinf = _rows_max_abs(r)[0]
        packed = self.comm.psum(torch.cat([torch.sum(r * r)[None], self.comm.onehot(rinf)]))
        return packed[0], torch.max(packed[1:])

    def _schur_step(self, x: torch.Tensor, lam: torch.Tensor):
        """The damped two-level step at the replicated ``x``: ``(d (n_vars,)
        in the solve dtype, replicated; fail; the Jacobian pass's
        degenerate flags (n_constraints,))``."""
        comm = self.comm
        jt = self.jac_dtype
        Pl, m, kb, n_b = self.Pl, self.m, self.kb, self.n_b
        x_loc, r, deg_j = self._stats(x)
        _r, jtj, jtr, _deg = self._local_j.normal_equations(x_loc, rhs=r)
        # No f32 damping floor (see block_schur.py).
        lam_j = lam.to(jt).reshape(1)
        a_ii, a_ib, a_bb, b_i, b_b = damped_blocks(
            jtj, jtr.reshape(1, Pl, m + kb), lam_j, self._imask, m)
        false = torch.zeros((1,), dtype=torch.bool, device=x.device)
        d_b = None
        if n_b:
            u, w_mat, fail_i = interior_solve(a_ii, a_ib, b_i)
            rhs_loc = self._seg_b((b_b - torch.einsum("bpmk,bpm->bpk", a_ib, u)).reshape(1, -1))
            if self.boundary_solver == "cg":
                d_b = self._cg_boundary(a_bb, a_ib, w_mat, lam_j, rhs_loc)
                fail_b = false
            elif self.boundary_solver == "banded":
                # The band and the rhs (an extra column) in ONE sum; then the
                # same banded solve on every rank.
                bw = self.band_bw
                s_contrib = a_bb - torch.einsum("bpmk,bpmj->bpkj", a_ib, w_mat)
                band_loc = self._seg_band(s_contrib.reshape(1, -1)).reshape(1, n_b, bw + 1)
                packed = comm.psum(torch.cat([band_loc, rhs_loc[..., None]], 2))
                band = packed[..., :bw + 1].clone()
                band[:, :, bw] += lam_j[:, None]
                d_b, fail_b = banded_spd_solve(band, packed[..., bw + 1].contiguous())
            else:
                # S and the rhs (an extra row) in ONE sum.
                s_contrib = a_bb - torch.einsum("bpmk,bpmj->bpkj", a_ib, w_mat)
                s_loc = self._seg_dense(s_contrib.reshape(1, -1)).reshape(1, n_b, n_b)
                packed = comm.psum(torch.cat([s_loc, rhs_loc[:, None, :]], 1))
                s_mat = packed[:, :n_b].clone()
                s_mat.diagonal(dim1=-2, dim2=-1).add_(lam_j[:, None])
                d_b, fail_b = spd_solve(s_mat, packed[:, n_b].contiguous())
            d_b_loc = torch.cat([d_b, d_b.new_zeros(1, 1)], 1)[:, self._bmap].reshape(1, Pl, kb)
            d_i = u - torch.einsum("bpmk,bpk->bpm", w_mat, d_b_loc)
        else:
            d_i, fail_i = spd_solve_batched(a_ii, b_i)
            fail_b = false
        d_i = d_i * self._imask
        # The interior steps are disjoint per rank; ONE sum unites them into
        # the replicated step, with the failure flag in slot n_vars + 1.
        n = self.n_vars
        d = torch.zeros((n + 2,), dtype=self.dtype, device=x.device)
        d[self._int_dst] = d_i.reshape(-1)[self._int_src].to(self.dtype)
        d[n + 1] = (fail_i.any() | fail_b[0]).to(self.dtype)
        dsum = comm.psum(d)
        fail = dsum[n + 1] > 0
        d = dsum[:n]
        if d_b is not None:
            d[self._boundary] += d_b[0].to(self.dtype)
        d = torch.where(fail, torch.zeros_like(d), d)
        return d, fail, deg_j[: self.n_constraints]

    def _cg_boundary(self, a_bb, a_ib, w_mat, lam_j, rhs_loc):
        """The boundary step by distributed Jacobi-PCG: diag(S) rides in the
        rhs's sum; each matvec is one (n_b,) sum."""
        comm = self.comm
        Pl, kb, n_b = self.Pl, self.kb, self.n_b
        diag_loc = self._seg_b((torch.diagonal(a_bb, dim1=-2, dim2=-1)
                                - torch.einsum("bpmk,bpmk->bpk", a_ib, w_mat)).reshape(1, -1))
        packed = comm.psum(torch.cat([rhs_loc, diag_loc], 1))
        rhs = packed[:, :n_b]
        diag_s = packed[:, n_b:] + lam_j[:, None]
        minv = torch.where(diag_s > 0, 1.0 / diag_s, torch.ones_like(diag_s))

        def s_matvec(v):
            v_loc = torch.cat([v, v.new_zeros(1, 1)], 1)[:, self._bmap].reshape(1, Pl, kb)
            t = torch.einsum("bpkj,bpj->bpk", a_bb, v_loc)
            t = t - torch.einsum("bpmk,bpm->bpk", a_ib,
                                 torch.einsum("bpmk,bpk->bpm", w_mat, v_loc))
            return comm.psum(self._seg_b(t.reshape(1, -1))) + lam_j[:, None] * v

        before = comm.collectives
        tol = self.cg_tol * torch.sqrt(torch.sum(rhs * rhs, dim=-1))
        d_b = _cg(s_matvec, rhs, None, tol, self.cg_max_iters, minv)
        # One matvec and one host sync per trip, and one last sync.
        trips = comm.collectives - before
        self.cg_trips += trips
        comm.host_syncs += trips + 1
        return d_b

    def counts(self) -> dict:
        """Counters of the last solve: collectives and their bytes, host
        syncs, LM trips (steps taken) and CG trips. ``self.history`` holds
        the last solve's max|r| after each trip (the kept point's)."""
        return self.comm.counts(lm_trips=self.lm_trips, cg_trips=self.cg_trips)

    def solve(self, x0) -> dict:
        """Solve from ``x0`` (n_vars,), the same on every rank. Returns the
        JAX solver's outcome dict (``x``, ``iterations``, ``converged``,
        ``satisfied``, ``degenerate``, ``residual_inf``, ``n_boundary``,
        ``n_interior``, ``n_parts``, ``n_devices``) in numpy and Python
        values, the same on every rank."""
        require_full_f32(self.device, self.jac_dtype, "ShardedBlockSchurSolver")
        comm = self.comm
        comm.reset()
        self.lm_trips = self.cg_trips = 0
        c = self.config
        n_cons = self.n_constraints
        max_it, rtol, stol = c.max_iterations, c.residual_tolerance, c.step_tolerance
        x = torch.as_tensor(np.asarray(x0), dtype=self.dtype, device=self.device)
        _xl, r, deg = self._stats(x)
        r2, rinf = self._global(r)
        lam = torch.as_tensor(c.initial_lambda, dtype=self.dtype, device=self.device)
        false = torch.zeros((), dtype=torch.bool, device=self.device)
        done, converged = false, false
        iterations = torch.zeros((), dtype=torch.int64, device=self.device)
        it = 0
        history = []
        while it < max_it and comm.read(~done & (rinf > rtol)):
            d, fail, deg_j = self._schur_step(x, lam)
            step_inf = torch.max(torch.abs(d)) if self.n_vars else torch.zeros_like(lam)
            x_new = x + d
            _xl, r_new, deg_r = self._stats(x_new)
            r2_new, rinf_new = self._global(r_new)
            accept = ~fail & (r2_new < r2)
            x = torch.where(accept, x_new, x)
            r2 = torch.where(accept, r2_new, r2)
            rinf = torch.where(accept, rinf_new, rinf)
            lam = torch.where(accept, lam * LM_LAMBDA_DECR, lam * LM_LAMBDA_INCR)
            deg = deg | deg_r
            deg[:n_cons] |= deg_j
            step_conv = ~fail & (step_inf <= stol)
            done = step_conv
            converged = converged | step_conv
            iterations = torch.where(step_conv, it, iterations)
            it += 1
            self.lm_trips += 1
            history.append(rinf)
        res_conv = rinf <= rtol
        converged = converged | res_conv
        iterations = torch.where(done, iterations, torch.where(res_conv, it, max_it))
        # Unsatisfied and degenerate flags are per rank (each constraint is
        # homed on one part): ONE max over the ranks.
        x_loc, _r, _d = self._stats(x)
        unsat = ~self._local.constraint_satisfaction(x_loc)[0]
        flags = comm.pmax(torch.cat([unsat, deg]).to(self.dtype))
        packed = torch.cat([x, flags[:n_cons], flags[n_cons + 1:2 * n_cons + 1],
                            torch.stack([converged.to(self.dtype), iterations.to(self.dtype),
                                         rinf, *history])]).cpu().numpy()
        comm.host_syncs += 1
        n = self.n_vars
        self.history = packed[n + 2 * n_cons + 3:].tolist()
        return dict(
            x=packed[:n],
            iterations=int(packed[n + 2 * n_cons + 1]),
            converged=bool(packed[n + 2 * n_cons]),
            satisfied=packed[n:n + n_cons] == 0,
            degenerate=packed[n + n_cons:n + 2 * n_cons] > 0,
            residual_inf=float(packed[n + 2 * n_cons + 2]),
            n_boundary=self.n_b,
            n_interior=self.m,
            n_parts=self.P,
            n_devices=self.D,
        )
