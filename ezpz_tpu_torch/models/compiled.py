"""Compile a constraint system to per-type arrays.

The PyTorch counterpart of ``ezpz_tpu/models/compiled.py``. Constraints
are grouped by kernel type into ``(n_type, nvars)`` index arrays and
``(n_type, nparams)`` parameter arrays (host numpy, exactly as the JAX
package builds them), and evaluated on torch tensors with a leading batch
axis: one call evaluates a whole fleet of sketches sharing the topology.

``jacobian_factors`` and ``jtj_matvec`` serve the matrix-free
``solver.solve_lm_cg``: the per-block weighted Jacobians, and JtJ times a
vector without the dense (n, n) JtJ.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import cached_property
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from ..constraints import Constraint
from ..ops.kernels import KERNELS, KernelSpec, jvp

EPSILON = 1e-4  # satisfaction tolerance, ezpz/src/lib.rs:43

_NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


def to_device(a, dtype=None, device=None) -> torch.Tensor:
    """``torch.as_tensor(a, dtype, device)``, counted as one host-to-device
    copy (``tracing``'s ``h2d.copies``) unless ``a`` is already a tensor.
    On the card such a copy from host memory waits for the stream to
    drain. Counted on every device, the CPU included."""
    if not isinstance(a, torch.Tensor):
        tracing.count("h2d.copies")
    return torch.as_tensor(a, dtype=dtype, device=device)


@dataclass(frozen=True)
class KindBlock:
    """All instances of one kernel type (host numpy arrays)."""

    spec: KernelSpec
    idx: np.ndarray  # (n, nvars) int32 — gather indices into x
    par: np.ndarray  # (n, nparams) float
    weight: np.ndarray  # (n,) float — constraint weights
    cid: np.ndarray  # (n,) int32 — originating constraint index


@dataclass(frozen=True)
class CompiledSystem:
    """A constraint system compiled to arrays.

    ``n_vars`` is the length of the flat variable vector (indexed by Id).
    Residual rows are grouped by kernel type (blocks in sorted kernel-name
    order, instances in constraint order, then the kernel's rows).

    Every evaluation method takes ``x`` of shape ``(..., n_vars)`` and an
    optional ``pars`` override: a tuple of ``(..., n_k, np_k)`` tensors
    aligned with ``blocks``. Without it the compile-time parameters apply.

    ``part_size`` > 0 declares ``x`` to be ``n_vars // part_size`` parts of
    ``part_size`` variables that no instance spans (the per-part systems of
    ``parallel.block_schur``): ``normal_equations`` then returns JtJ as its
    diagonal blocks, ``(B, n_parts, part_size, part_size)``.
    """

    n_vars: int
    n_constraints: int
    n_rows: int
    blocks: Tuple[KindBlock, ...]
    dtype: torch.dtype = torch.float64
    part_size: int = 0

    def _pars(self, pars, i, like):
        if pars is None:
            return to_device(self.blocks[i].par, dtype=like.dtype,
                                   device=like.device)
        return pars[i]

    def residual(self, x: torch.Tensor, pars=None) -> torch.Tensor:
        """Weighted residual ``(..., n_rows)`` (the reference's
        ``Model::residual``, ``solver.rs:318-356``, up to row order)."""
        return self.residual_and_flags(x, pars)[0]

    def residual_and_flags(self, x: torch.Tensor, pars=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weighted residual ``(..., n_rows)``, per-constraint degenerate
        flags ``(..., n_constraints)`` bool)."""
        batch = x.shape[:-1]
        parts = []
        deg_acc = torch.zeros(batch + (self.n_constraints,), dtype=torch.int32,
                              device=x.device)
        for i, b in enumerate(self.blocks):
            idx = to_device(b.idx, dtype=torch.long, device=x.device)
            v = x[..., idx]  # (..., nb, nv)
            p = self._pars(pars, i, x)  # (..., nb, np)
            res, deg = b.spec.fn([v[..., k] for k in range(b.spec.nvars)],
                                 [p[..., k] for k in range(b.spec.nparams)])
            w = to_device(b.weight, dtype=x.dtype, device=x.device)
            res = torch.movedim(res, 0, -1) * w[:, None]  # (..., nb, dim)
            parts.append(res.reshape(batch + (-1,)))
            if b.spec.can_degenerate:
                cid = to_device(b.cid, dtype=torch.long, device=x.device)
                deg_acc.index_add_(-1, cid, deg.to(torch.int32))
        if parts:
            r = torch.cat(parts, dim=-1)
        else:
            r = torch.zeros(batch + (0,), dtype=x.dtype, device=x.device)
        return r, deg_acc > 0

    def normal_equations(self, x: torch.Tensor, pars=None,
                         rhs: Optional[torch.Tensor] = None):
        """``(r (B, n_rows), JtJ (B, n, n), Jtr (B, n), degenerate flags
        (B, n_constraints))`` at ``x`` (B, n_vars) (JtJ in diagonal blocks
        when ``part_size`` is set).

        Jacobian columns come by forward mode per kernel (``torch.func.jvp``
        with one-hot tangents, one per instance variable). JtJ and Jtr are
        accumulated from per-instance products in the JAX package's order:
        block by block, instance by instance (``_assembly``), with fixed
        gathers and adds, so the sums are deterministic on any device.

        ``rhs`` optionally substitutes an already-evaluated weighted
        residual (possibly wider; it is cast to this system's dtype) for the
        right-hand side: ``jtr = J^T cast(rhs)``. ``x`` is cast likewise, so
        the call is valid on an f32 twin with f64 inputs."""
        x = x.to(self.dtype)
        B = x.shape[0]
        dev = x.device
        parts, jj, jr = [], [], []
        deg_acc = torch.zeros((B, self.n_constraints), dtype=torch.int32, device=dev)
        slices = self.block_row_slices()
        with tracing.span("ezpz.lm.jacobian"):
            for i, b in enumerate(self.blocks):
                spec = b.spec
                res, wjac, deg, w = self._weighted_jacobian(i, x, pars)
                if rhs is None:
                    wres = [res[d] * w for d in range(spec.dim)]
                else:
                    lo, hi = slices[i]
                    r_b = rhs[:, lo:hi].to(self.dtype).reshape(B, -1, spec.dim)
                    wres = [r_b[..., d] for d in range(spec.dim)]
                for ka in wjac:
                    jr.append(_dot(ka, wres))
                    jj.extend(_dot(ka, la) for la in wjac)
                parts.append(torch.stack(wres, dim=-1).reshape(B, -1))
                if spec.can_degenerate:
                    cid = to_device(b.cid, dtype=torch.long, device=dev)
                    deg_acc.index_add_(-1, cid, deg.to(torch.int32))
        jtj, jtr = self._assemble(jj, jr, B, x)
        if parts:
            r = torch.cat(parts, dim=-1)
        else:
            r = torch.zeros((B, 0), dtype=self.dtype, device=dev)
        return r, jtj, jtr, deg_acc > 0

    def _weighted_jacobian(self, i: int, x: torch.Tensor, pars):
        """Block ``i`` at ``x`` (B, n_vars): ``(res (dim, B, nb), wjac,
        deg (B, nb), w (nb,))``, where ``wjac[a][d]`` (B, nb) is the
        weighted derivative of row ``d`` by the instance's variable ``a``,
        by ``torch.func.jvp`` with one one-hot tangent per variable."""
        b = self.blocks[i]
        spec = b.spec
        dev = x.device
        idx = to_device(b.idx, dtype=torch.long, device=dev)
        v = x[:, idx]  # (B, nb, nv)
        vs = tuple(v[..., k] for k in range(spec.nvars))
        p = self._pars(pars, i, x)
        ps = [p[..., k] for k in range(spec.nparams)]
        one, zero = torch.ones_like(vs[0]), torch.zeros_like(vs[0])
        w = to_device(b.weight, dtype=self.dtype, device=dev)
        wjac = []
        for a in range(spec.nvars):
            tangent = tuple(one if r == a else zero for r in range(spec.nvars))
            res, dres, deg = jvp(lambda *vv, fn=spec.fn: fn(vv, ps), vs, tangent)
            wjac.append([dres[d] * w for d in range(spec.dim)])
        return res, wjac, deg, w

    def jacobian_factors(self, x: torch.Tensor, pars=None):
        """Per-block weighted Jacobians and the residual at ``x`` (B,
        n_vars), for matrix-free JtJ products (systems whose dense (n, n)
        JtJ does not fit). Returns ``(r (B, n_rows), jtr (B, n_vars),
        wjacs, deg (B, n_constraints))``, where ``wjacs[i]`` is block
        ``i``'s weighted Jacobian (B, nb, dim, nv). ``jtr`` is summed by
        the fixed gathers of ``normal_equations``, in the JAX package's
        scatter order."""
        x = x.to(self.dtype)
        B = x.shape[0]
        dev = x.device
        parts, jr, wjacs = [], [], []
        deg_acc = torch.zeros((B, self.n_constraints), dtype=torch.int32, device=dev)
        for i, b in enumerate(self.blocks):
            spec = b.spec
            res, wjac, deg, w = self._weighted_jacobian(i, x, pars)
            wres = [res[d] * w for d in range(spec.dim)]
            jr.extend(_dot(ka, wres) for ka in wjac)
            wjacs.append(torch.stack([torch.stack(ka, dim=-1) for ka in wjac], dim=-1))
            parts.append(torch.stack(wres, dim=-1).reshape(B, -1))
            if spec.can_degenerate:
                cid = to_device(b.cid, dtype=torch.long, device=dev)
                deg_acc.index_add_(-1, cid, deg.to(torch.int32))
        if parts:
            r = torch.cat(parts, dim=-1)
        else:
            r = torch.zeros((B, 0), dtype=self.dtype, device=dev)
        return r, self._plan_sum(self._assembly[1], jr, B, x), wjacs, deg_acc > 0

    def jtj_matvec(self, wjacs, v: torch.Tensor) -> torch.Tensor:
        """``JtJ v`` (B, n_vars) for ``v`` (B, n_vars) without forming JtJ:
        per block, gather ``v``, contract with the rows (``J v``) and back
        (``J^T (J v)``), then sum per variable by the fixed gathers of
        ``jacobian_factors`` (O(nnz), deterministic on any device)."""
        B = v.shape[0]
        idxs, entries, gather, size = self._matvec_tables(v.device)
        cols = []
        for idx, wjac in zip(idxs, wjacs):
            vg = v[:, idx]  # (B, nb, nv)
            t = torch.sum(wjac * vg[:, :, None, :], dim=-1)  # (B, nb, dim)
            back = torch.sum(wjac * t[..., None], dim=-2)  # (B, nb, nv)
            cols.append(back.transpose(1, 2).reshape(B, -1))  # [k, instance]
        vals = (torch.cat(cols, dim=1) if cols
                else torch.zeros((B, 0), dtype=self.dtype, device=v.device))
        return gather_sum(vals, entries, gather, size)

    def _matvec_tables(self, dev):
        """The blocks' gather indices and the Jtr plan on ``dev``, copied
        there once per device: ``jtj_matvec`` runs once per CG trip."""
        cache = self.__dict__.setdefault("_matvec_tables_by_device", {})
        if dev not in cache:
            entries, gather, size = self._assembly[1]
            cache[dev] = (
                tuple(to_device(b.idx, dtype=torch.long, device=dev)
                      for b in self.blocks),
                to_device(entries, device=dev),
                to_device(gather, device=dev), size)
        return cache[dev]

    def jacobian_dense(self, x: torch.Tensor, pars=None) -> torch.Tensor:
        """Weighted dense Jacobians ``(B, n_rows, n_vars)`` at ``x`` (B,
        n_vars), rows in compiled row order (the freedom analysis's input).
        An instance that names one variable twice adds both derivatives
        into its column, as the JAX package's scatter-add does."""
        x = x.to(self.dtype)
        B = x.shape[0]
        dev = x.device
        J = torch.zeros((B, self.n_rows, self.n_vars), dtype=self.dtype, device=dev)
        for i, (b, (lo, _hi)) in enumerate(zip(self.blocks, self.block_row_slices())):
            nb, dim = int(b.idx.shape[0]), b.spec.dim
            _res, wjac, _deg, _w = self._weighted_jacobian(i, x, pars)
            rows = lo + (torch.arange(nb, device=dev)[:, None] * dim
                         + torch.arange(dim, device=dev)[None, :])  # (nb, dim)
            idx = to_device(b.idx, dtype=torch.long, device=dev)
            for a, col in enumerate(wjac):
                # One variable slot at a time: its (row, column) pairs are
                # distinct, so each update is a plain gather-add-scatter.
                J[:, rows, idx[:, a:a + 1]] += torch.stack(col, dim=-1)
        return J

    def _assemble(self, jj, jr, B, like):
        """Sum per-instance products into JtJ (B, n, n), or its diagonal
        blocks (B, n / s, s, s) for ``part_size`` s, and Jtr (B, n).
        ``jj`` holds, per block, one (B, nb) tensor for each (k, l) pair of
        instance variables; ``jr`` one for each k."""
        n = self.n_vars
        with tracing.span("ezpz.lm.assemble"):
            jtj = self._plan_sum(self._assembly[0], jj, B, like)
            jtr = self._plan_sum(self._assembly[1], jr, B, like)
        if self.part_size:
            s = self.part_size
            return jtj.reshape(B, n // s, s, s), jtr
        return jtj.reshape(B, n, n), jtr

    def _plan_sum(self, plan, vals, B, like):
        """One of ``_assembly``'s scatter-adds as fixed gathers: ``vals``
        holds (B, ...) tensors whose concatenated columns are in the plan's
        numbering ([block, (k[, l]), instance])."""
        entries, gather, size = plan
        dev = like.device
        cols = (torch.cat(vals, dim=1) if vals
                else torch.zeros((B, 0), dtype=self.dtype, device=dev))
        return gather_sum(cols, to_device(entries, device=dev),
                          to_device(gather, device=dev), size)

    @cached_property
    def _assembly(self):
        """Host plan of ``_assemble``, built once: for JtJ (flattened n*n,
        or its flattened diagonal blocks) and Jtr, the entries that receive
        contributions, and per entry the contribution columns to add, in the
        JAX package's scatter order (block, instance, then k, l), padded
        with the zero column."""
        n = self.n_vars
        s = self.part_size or max(n, 1)

        def jj_key(i, j):
            return (i // s) * s * s + (i % s) * s + j % s

        jj_lists, jr_lists = {}, {}
        off_jj = off_jr = 0
        for b in self.blocks:
            nb, nv = b.idx.shape
            for inst in range(nb):
                ids = [int(j) for j in b.idx[inst]]
                for k in range(nv):
                    jr_lists.setdefault(ids[k], []).append(off_jr + k * nb + inst)
                    for l in range(nv):
                        jj_lists.setdefault(jj_key(ids[k], ids[l]), []).append(
                            off_jj + (k * nv + l) * nb + inst)
            off_jj += nb * nv * nv
            off_jr += nb * nv
        plan = []
        for lists, zero_col, size in ((jj_lists, off_jj, (n // s) * s * s),
                                      (jr_lists, off_jr, n)):
            entries = sorted(lists)
            width = max((len(v) for v in lists.values()), default=0)
            gather = np.full((len(entries), width), zero_col, dtype=np.int64)
            for row, e in enumerate(entries):
                gather[row, :len(lists[e])] = lists[e]
            plan.append((np.asarray(entries, dtype=np.int64), gather, size))
        return tuple(plan)

    def refine_normal_equations(self, x64: torch.Tensor, r64: torch.Tensor,
                                pars=None):
        """Mixed-precision normal equations for iterative refinement: the
        Jacobian in this system's dtype (call on the f32 twin) at
        ``x64`` cast, against the f64 residual ``r64`` cast:
        ``jtr = J32^T cast(r64)``. Returns ``(jtj, jtr, deg)``."""
        _r, jtj, jtr, deg = self.normal_equations(x64, pars, rhs=r64)
        return jtj, jtr, deg

    def constraint_satisfaction(self, x: torch.Tensor, pars=None) -> torch.Tensor:
        """Per-constraint satisfaction from a fresh evaluation: every
        unweighted residual row below 1e-4 (``ezpz/src/lib.rs:307-327``).
        A NaN row is unsatisfied. Returns (..., n_constraints) bool."""
        batch = x.shape[:-1]
        unsat = torch.zeros(batch + (self.n_constraints,), dtype=torch.int32,
                            device=x.device)
        for i, b in enumerate(self.blocks):
            idx = to_device(b.idx, dtype=torch.long, device=x.device)
            v = x[..., idx]
            p = self._pars(pars, i, x)
            res, _deg = b.spec.fn([v[..., k] for k in range(b.spec.nvars)],
                                  [p[..., k] for k in range(b.spec.nparams)])
            bad = ~(torch.abs(res) < EPSILON).all(dim=0)  # (..., nb)
            cid = to_device(b.cid, dtype=torch.long, device=x.device)
            unsat.index_add_(-1, cid, bad.to(torch.int32))
        return unsat == 0

    def all_weights_positive(self) -> bool:
        return all(float(np.min(b.weight)) > 0.0 for b in self.blocks) if self.blocks else True

    def param_arrays(self) -> Tuple[np.ndarray, ...]:
        """The compile-time parameter arrays, aligned with ``blocks``: the
        template of batched ``pars`` overrides."""
        return tuple(b.par for b in self.blocks)

    def block_row_slices(self) -> Tuple[Tuple[int, int], ...]:
        """(start, stop) row ranges of each block inside the concatenated
        residual vector (compiled row order)."""
        out = []
        row = 0
        for b in self.blocks:
            n = int(b.idx.shape[0]) * b.spec.dim
            out.append((row, row + n))
            row += n
        return tuple(out)

    def satisfaction_from_residual(self, r: torch.Tensor) -> torch.Tensor:
        """Per-constraint satisfaction from an evaluated weighted residual
        ``(..., n_rows)``: every unweighted row ``|r| / w`` below 1e-4
        (valid when every weight > 0). A NaN row is unsatisfied."""
        rows_cid = np.concatenate(
            [np.repeat(b.cid, b.spec.dim) for b in self.blocks]
        ) if self.blocks else np.zeros((0,), np.int32)
        rows_w = np.concatenate(
            [np.repeat(np.asarray(b.weight, np.float64), b.spec.dim)
             for b in self.blocks]
        ) if self.blocks else np.zeros((0,))
        w = to_device(rows_w, dtype=r.dtype, device=r.device)
        bad = ~(torch.abs(r) / w < EPSILON)
        unsat = torch.zeros(r.shape[:-1] + (self.n_constraints,),
                            dtype=torch.int32, device=r.device)
        unsat.index_add_(-1, to_device(rows_cid, dtype=torch.long, device=r.device),
                         bad.to(torch.int32))
        return unsat == 0

    def satisfaction(self, x: torch.Tensor, r: torch.Tensor, pars=None) -> torch.Tensor:
        """Per-constraint satisfaction of a solved point ``x`` with its
        weighted residual ``r``: read from ``r`` when every weight is
        positive (no extra evaluation), else from a fresh evaluation at
        ``x``."""
        if self.all_weights_positive():
            return self.satisfaction_from_residual(r)
        return self.constraint_satisfaction(x, pars)

    def astype(self, dtype: torch.dtype) -> "CompiledSystem":
        """The same topology with parameters/weights in another dtype."""
        if dtype == self.dtype:
            return self
        npd = _NP_DTYPE[dtype]
        blocks = tuple(
            replace(b, par=b.par.astype(npd), weight=b.weight.astype(npd))
            for b in self.blocks
        )
        return replace(self, blocks=blocks, dtype=dtype)


def gather_sum(vals: torch.Tensor, entries: torch.Tensor, gather: torch.Tensor,
               size: int) -> torch.Tensor:
    """A scatter-add as fixed gathers and adds, the same on every device:
    ``out[:, entries[e]]`` (B, size) is the sum of ``vals[:, gather[e, c]]``
    (B, n_in) over c in order, a column index of ``n_in`` standing for zero
    (it pads the shorter lists); other outputs are zero."""
    out = torch.zeros((vals.shape[0], size), dtype=vals.dtype, device=vals.device)
    if len(entries):
        cols = torch.cat([vals, torch.zeros_like(vals[:, :1])], dim=1)
        acc = cols[:, gather[:, 0]]
        for c in range(1, gather.shape[1]):
            acc = acc + cols[:, gather[:, c]]
        out[:, entries] = acc
    return out


def _dot(a, b):
    """``a[0]*b[0] + a[1]*b[1] + ...`` over lists of tensors, in order."""
    acc = a[0] * b[0]
    for u, v in zip(a[1:], b[1:]):
        acc = acc + u * v
    return acc


def compile_system(
    constraints: Sequence[Constraint],
    n_vars: int,
    weights: Optional[Sequence[float]] = None,
    dtype: torch.dtype = torch.float64,
) -> CompiledSystem:
    """Group lowered kernel instances by type into arrays (the JAX
    package's ``compile_system``, array for array).

    ``constraints`` must already have tangency sides resolved
    (``Constraint.set_from_initial_values``).
    """
    if weights is None:
        weights = [1.0] * len(constraints)
    npd = _NP_DTYPE[dtype]
    by_kind: dict = {}
    n_rows = 0
    for cid, (c, w) in enumerate(zip(constraints, weights)):
        for inst in c.lower():
            spec = KERNELS[inst.kernel]
            slot = by_kind.setdefault(inst.kernel, {"idx": [], "par": [], "w": [], "cid": []})
            if len(inst.var_ids) != spec.nvars or len(inst.params) != spec.nparams:
                raise ValueError(f"bad arity for {inst.kernel}: {inst}")
            slot["idx"].append(inst.var_ids)
            slot["par"].append(inst.params)
            slot["w"].append(w)
            slot["cid"].append(cid)
            n_rows += spec.dim

    blocks = []
    for kernel_name in sorted(by_kind.keys()):
        slot = by_kind[kernel_name]
        spec = KERNELS[kernel_name]
        nb = len(slot["idx"])
        blocks.append(
            KindBlock(
                spec=spec,
                idx=np.asarray(slot["idx"], dtype=np.int32).reshape(nb, spec.nvars),
                par=np.asarray(slot["par"], dtype=np.float64).reshape(nb, spec.nparams)
                .astype(npd),
                weight=np.asarray(slot["w"], dtype=np.float64).astype(npd),
                cid=np.asarray(slot["cid"], dtype=np.int32),
            )
        )

    return CompiledSystem(
        n_vars=n_vars,
        n_constraints=len(constraints),
        n_rows=n_rows,
        blocks=tuple(blocks),
        dtype=dtype,
    )


def topology_key(constraints: Sequence[Constraint], n_vars: int) -> tuple:
    """A hashable key of the compiled topology: kernel ids, variable ids
    and parameter values (the public API's solver cache key).

    The per-constraint fragment is memoized on the (immutable) constraint:
    this runs on every public solve."""
    items = []
    for c in constraints:
        frag = c.__dict__.get("_topo_frag")
        if frag is None:
            frag = tuple(
                (inst.kernel, inst.var_ids, inst.params) for inst in c.lower()
            )
            object.__setattr__(c, "_topo_frag", frag)
        items.append(frag)
    return (n_vars, tuple(items))


def from_reference(fields) -> CompiledSystem:
    """The port's ``CompiledSystem`` for a JAX-package ``CompiledSystem``
    given as plain data: a mapping with ``n_vars``, ``n_constraints``,
    ``n_rows`` and ``blocks``, a sequence of ``(spec.name, idx, par,
    weight, cid)`` numpy tuples. Lets one topology feed both packages."""
    blocks = []
    for name, idx, par, weight, cid in fields["blocks"]:
        blocks.append(KindBlock(
            spec=KERNELS[name],
            idx=np.asarray(idx, dtype=np.int32),
            par=np.asarray(par),
            weight=np.asarray(weight),
            cid=np.asarray(cid, dtype=np.int32),
        ))
    par_dtypes = {b.par.dtype for b in blocks}
    dtype = torch.float32 if par_dtypes == {np.dtype(np.float32)} else torch.float64
    return CompiledSystem(
        n_vars=int(fields["n_vars"]),
        n_constraints=int(fields["n_constraints"]),
        n_rows=int(fields["n_rows"]),
        blocks=tuple(blocks),
        dtype=dtype,
    )
