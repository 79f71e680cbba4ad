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

from dataclasses import dataclass, field, replace
from functools import cached_property
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from ..constraints import Constraint
from ..ops import lm_jacobian
from ..ops.device_cache import copies, on_device, to_device
from ..ops.kernels import KERNELS, KernelSpec

EPSILON = 1e-4  # satisfaction tolerance, ezpz/src/lib.rs:43

_NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


@dataclass(frozen=True)
class KindBlock:
    """All instances of one kernel type (host numpy arrays)."""

    spec: KernelSpec
    idx: np.ndarray  # (n, nvars) int32 — gather indices into x
    par: np.ndarray  # (n, nparams) float
    weight: np.ndarray  # (n,) float — constraint weights
    cid: np.ndarray  # (n,) int32 — originating constraint index


@dataclass(frozen=True)
class SystemTables(lm_jacobian.JacobianTables):
    """One system's tables on one device (``CompiledSystem.tables``): what
    ``ops.lm_jacobian.products`` reads, and what every other evaluation reads."""

    inst_cid: torch.Tensor  # (n_inst,) long: each instance's constraint
    row_weight: torch.Tensor  # (n_rows,) in the system's dtype: each residual row's weight
    row_cid: torch.Tensor  # (n_rows,) long: each residual row's constraint
    # ``_assembly``'s JtJ and Jtr plans on the device, copied at first use:
    # a system that only evaluates residuals never builds them.
    plans: Tuple[dict, dict] = field(default_factory=lambda: ({}, {}), compare=False,
                                     repr=False)


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

    def tables(self, dev) -> SystemTables:
        """This system's tables on ``dev``, copied there at that device's
        first call (``ops.device_cache.on_device``)."""
        return on_device(self.__dict__.setdefault("_tables", {}), dev, self._make_tables)

    def _make_tables(self, dev) -> SystemTables:
        def per_row(arrays):
            return np.concatenate([np.repeat(a, b.spec.dim) for a, b in zip(arrays, self.blocks)]
                                  or [np.zeros(0)])

        cids = [b.cid for b in self.blocks]
        return SystemTables(
            **vars(lm_jacobian.jacobian_tables(self.blocks, self.dtype, dev)),
            inst_cid=to_device(np.concatenate(cids or [np.zeros(0)]), dtype=torch.long,
                               device=dev),
            row_weight=to_device(per_row([b.weight for b in self.blocks]), dtype=self.dtype,
                                 device=dev),
            row_cid=to_device(per_row(cids), dtype=torch.long, device=dev))

    def _plan(self, k: int, dev):
        """``_assembly[k]`` (0: JtJ, 1: Jtr) as ``(entries, gather, size)``
        with its tables on ``dev``, copied there at the first call."""
        entries, gather, size = self._assembly[k]
        return (*on_device(self.tables(dev).plans[k], dev, copies((entries, gather))), size)

    def residual(self, x: torch.Tensor, pars=None) -> torch.Tensor:
        """Weighted residual ``(..., n_rows)`` (the reference's
        ``Model::residual``, ``solver.rs:318-356``, up to row order)."""
        return self.residual_and_flags(x, pars)[0]

    def residual_and_flags(self, x: torch.Tensor, pars=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weighted residual ``(..., n_rows)``, per-constraint degenerate
        flags ``(..., n_constraints)`` bool)."""
        batch = x.shape[:-1]
        t = self.tables(x.device)
        parts, degs = [], []
        for i, (spec, res, deg) in enumerate(self._evaluate(x, pars, t)):
            res = torch.movedim(res, 0, -1) * t.weight[i].to(x.dtype)[:, None]  # (..., nb, dim)
            parts.append(res.reshape(batch + (-1,)))
            if spec.can_degenerate:
                degs.append(deg.to(torch.int32))
        if parts:
            r = torch.cat(parts, dim=-1)
        else:
            r = torch.zeros(batch + (0,), dtype=x.dtype, device=x.device)
        return r, self._count(batch, t.cid, degs) > 0

    def _evaluate(self, x, pars, t: SystemTables):
        """Each block's ``(spec, unweighted rows (dim, ..., nb), degenerate
        flags (..., nb))`` at ``x``, its tables ``t`` cast to ``x``'s dtype."""
        for i, b in enumerate(self.blocks):
            v = x[..., t.idx[i]]  # (..., nb, nv)
            p = t.par[i].to(x.dtype) if pars is None else pars[i]  # (..., nb, np)
            yield (b.spec, *b.spec.fn([v[..., k] for k in range(b.spec.nvars)],
                                      [p[..., k] for k in range(b.spec.nparams)]))

    def _count(self, batch, cid, flags):
        """``(*batch, n_constraints)`` int32: per constraint, the sum of the
        int32 ``flags`` (a list of (*batch, nb), concatenated along ``cid``)."""
        acc = torch.zeros(batch + (self.n_constraints,), dtype=torch.int32,
                          device=cid.device)
        if flags:
            acc.index_add_(-1, cid, flags[0] if len(flags) == 1 else torch.cat(flags, dim=-1))
        return acc

    def normal_equations(self, x: torch.Tensor, pars=None,
                         rhs: Optional[torch.Tensor] = None, band=None):
        """``(r (B, n_rows), JtJ (B, n, n), Jtr (B, n), degenerate flags
        (B, n_constraints))`` at ``x`` (B, n_vars) (JtJ in diagonal blocks
        when ``part_size`` is set, in the lower band (B, n, bw+1) of a band
        route ``band``: ``ops.banded.BandRoute``, by ``band_plan``).

        The weighted Jacobian's per-instance products come from
        ``ops.lm_jacobian.products``: on the card one kernel launch, on the
        CPU its plain version (forward mode per kernel, ``torch.func.jvp``
        with one-hot tangents). JtJ and Jtr are accumulated from those
        products in the JAX package's order: block by block, instance by
        instance (``_assembly``), with fixed gathers and adds, so the sums
        are deterministic on any device.

        ``rhs`` optionally substitutes an already-evaluated weighted
        residual (possibly wider: its first ``n_rows`` columns are taken,
        cast to this system's dtype) for the right-hand side: ``jtr = J^T
        cast(rhs)``. ``x`` is cast likewise, so the call is valid on an f32
        twin with f64 inputs."""
        x = x.to(self.dtype)
        tables = self.tables(x.device)
        with tracing.span("ezpz.lm.jacobian"):
            if rhs is not None:
                rhs = rhs[:, :self.n_rows].to(self.dtype)
            r, jj, jr, deg = lm_jacobian.products(tables, x, pars, rhs)
            deg_acc = self._count((x.shape[0],), tables.cid, [deg] if tables.n_deg else [])
        jtj, jtr = self._assemble(jj, jr, band)
        return r, jtj, jtr, deg_acc > 0

    def _weighted_jacobian(self, i: int, x: torch.Tensor, pars):
        """Block ``i`` at ``x`` (B, n_vars): ``(res (dim, B, nb), wjac,
        deg (B, nb), w (nb,))``, where ``wjac[a][d]`` (B, nb) is the
        weighted derivative of row ``d`` by the instance's variable ``a``
        (``lm_jacobian.weighted_jacobian``)."""
        t = self.tables(x.device)
        w = t.weight[i]
        res, wjac, deg = lm_jacobian.weighted_jacobian(
            self.blocks[i].spec, x[:, t.idx[i]], t.par[i] if pars is None else pars[i], w)
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
        parts, jr, wjacs, degs = [], [], [], []
        for i, b in enumerate(self.blocks):
            spec = b.spec
            res, wjac, deg, w = self._weighted_jacobian(i, x, pars)
            wres = [res[d] * w for d in range(spec.dim)]
            jr.extend(lm_jacobian.dot(ka, wres) for ka in wjac)
            wjacs.append(torch.stack([torch.stack(ka, dim=-1) for ka in wjac], dim=-1))
            parts.append(torch.stack(wres, dim=-1).reshape(B, -1))
            if spec.can_degenerate:
                degs.append(deg.to(torch.int32))
        if parts:
            r = torch.cat(parts, dim=-1)
        else:
            r = torch.zeros((B, 0), dtype=self.dtype, device=dev)
        jr.append(x.new_zeros((B, 1)))
        jtr = gather_sum_padded(torch.cat(jr, dim=1), *self._plan(1, dev))
        return r, jtr, wjacs, self._count((B,), self.tables(dev).cid, degs) > 0

    def jtj_matvec(self, wjacs, v: torch.Tensor) -> torch.Tensor:
        """``JtJ v`` (B, n_vars) for ``v`` (B, n_vars) without forming JtJ:
        per block, gather ``v``, contract with the rows (``J v``) and back
        (``J^T (J v)``), then sum per variable by the fixed gathers of
        ``jacobian_factors`` (O(nnz), deterministic on any device)."""
        B = v.shape[0]
        cols = []
        for idx, wjac in zip(self.tables(v.device).idx, wjacs):
            vg = v[:, idx]  # (B, nb, nv)
            t = torch.sum(wjac * vg[:, :, None, :], dim=-1)  # (B, nb, dim)
            back = torch.sum(wjac * t[..., None], dim=-2)  # (B, nb, nv)
            cols.append(back.transpose(1, 2).reshape(B, -1))  # [k, instance]
        vals = (torch.cat(cols, dim=1) if cols
                else torch.zeros((B, 0), dtype=self.dtype, device=v.device))
        return gather_sum(vals, *self._plan(1, v.device))

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
            idx = self.tables(dev).idx[i]
            for a, col in enumerate(wjac):
                # One variable slot at a time: its (row, column) pairs are
                # distinct, so each update is a plain gather-add-scatter.
                J[:, rows, idx[:, a:a + 1]] += torch.stack(col, dim=-1)
        return J

    def _assemble(self, jj, jr, band=None):
        """Sum per-instance products into JtJ (B, n, n), or its diagonal
        blocks (B, n / s, s, s) for ``part_size`` s, or the lower band (B,
        n, bw+1) of the route ``band``, and Jtr (B, n). ``jj`` (B, n_jj + 1)
        holds every block's (k, l) products of instance variables, ``jr``
        (B, n_jr + 1) its k products, in ``_assembly``'s numbering, each
        ending in a zero column (``ops.lm_jacobian.products``). A band
        assembly counts one ``lm.band_steps`` (``tracing``)."""
        n = self.n_vars
        B = jj.shape[0]
        with tracing.span("ezpz.lm.assemble"):
            if band is not None:
                entries, gather, _fwd, _inv = band.tables(jj.device)
                jtj = gather_sum_padded(jj, entries, gather, n * (band.bw + 1))
                tracing.count("lm.band_steps")
            else:
                jtj = gather_sum_padded(jj, *self._plan(0, jj.device))
            jtr = gather_sum_padded(jr, *self._plan(1, jr.device))
        if band is not None:
            return jtj.reshape(B, n, band.bw + 1), jtr
        if self.part_size:
            s = self.part_size
            return jtj.reshape(B, n // s, s, s), jtr
        return jtj.reshape(B, n, n), jtr

    @cached_property
    def _assembly(self):
        """Host plan of ``_assemble``, built once: for JtJ (flattened n*n,
        or its flattened diagonal blocks) and Jtr, the entries that receive
        contributions, and per entry the contribution columns to add, in the
        JAX package's scatter order (block, instance, then k, l), padded
        with the zero column. The columns are where ``ops.lm_jacobian``
        writes each product (its ``instance_table`` and
        ``product_columns``)."""
        n = self.n_vars
        s = self.part_size or max(n, 1)

        def jj_key(i, j):
            return (i // s) * s * s + (i % s) * s + j % s

        jj_lists, jr_lists = {}, {}
        inst, n_jj, n_jr, _n_deg = lm_jacobian.instance_table(self.blocks)
        lo = 0
        for b in self.blocks:
            nb, nv = b.idx.shape
            jj_cols, jr_cols = lm_jacobian.product_columns(inst[lo:lo + nb], nv)
            lo += nb
            for ids, jj_i, jr_i in zip(b.idx.tolist(), jj_cols.tolist(), jr_cols.tolist()):
                for k in range(nv):
                    jr_lists.setdefault(ids[k], []).append(jr_i[k])
                    for l in range(nv):
                        jj_lists.setdefault(jj_key(ids[k], ids[l]), []).append(jj_i[k][l])
        plan = []
        for lists, zero_col, size in ((jj_lists, n_jj, (n // s) * s * s),
                                      (jr_lists, n_jr, n)):
            entries = sorted(lists)
            width = max((len(v) for v in lists.values()), default=0)
            gather = np.full((len(entries), width), zero_col, dtype=np.int64)
            for row, e in enumerate(entries):
                gather[row, :len(lists[e])] = lists[e]
            plan.append((np.asarray(entries, dtype=np.int64), gather, size))
        return tuple(plan)

    def band_plan(self, perm, bw: int):
        """Host plan of JtJ's lower band (B, n, bw+1) in the ordering
        ``perm`` (None for the identity; ``ops.banded.plan_band``), in
        ``_assembly``'s form ``(entries, gather, n * (bw+1))``: band entry
        ``(i, d)``, flattened ``i * (bw+1) + d``, is the dense entry
        ``(perm[i], perm[i - bw + d])`` and takes exactly that entry's
        contribution list, in the same order, so both forms hold the same
        sums. Band entries with no contributions, and those left of column
        0, stay zero. Raises ValueError when a JtJ entry lies outside the
        band."""
        if self.part_size:
            raise ValueError("band_plan needs the whole JtJ (part_size 0)")
        entries, gather, _size = self._assembly[0]
        n = self.n_vars
        p = np.arange(n) if perm is None else np.asarray(perm, dtype=np.int64)
        pos = np.argsort(p)
        if np.any(np.abs(pos[entries // max(n, 1)] - pos[entries % max(n, 1)]) > bw):
            raise ValueError(f"JtJ has entries outside the band of half-width {bw}")
        rows = np.arange(n)[:, None]
        cols = rows - bw + np.arange(bw + 1)[None, :]
        keys = np.where(cols >= 0, p[rows] * n + p[np.clip(cols, 0, max(n - 1, 0))], -1)
        hit = np.isin(keys, entries)
        return (np.flatnonzero(hit), gather[np.searchsorted(entries, keys[hit])],
                n * (bw + 1))

    def constraint_satisfaction(self, x: torch.Tensor, pars=None) -> torch.Tensor:
        """Per-constraint satisfaction from a fresh evaluation: every
        unweighted residual row below 1e-4 (``ezpz/src/lib.rs:307-327``).
        A NaN row is unsatisfied. Returns (..., n_constraints) bool."""
        t = self.tables(x.device)
        bad = [(~(torch.abs(res) < EPSILON).all(dim=0)).to(torch.int32)  # (..., nb)
               for _spec, res, _deg in self._evaluate(x, pars, t)]
        return self._count(x.shape[:-1], t.inst_cid, bad) == 0

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
        t = self.tables(r.device)
        bad = ~(torch.abs(r) / t.row_weight.to(r.dtype) < EPSILON)
        return self._count(r.shape[:-1], t.row_cid, [bad.to(torch.int32)]) == 0

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
    return gather_sum_padded(torch.cat([vals, torch.zeros_like(vals[:, :1])], dim=1),
                             entries, gather, size)


def gather_sum_padded(cols: torch.Tensor, entries: torch.Tensor, gather: torch.Tensor,
                      size: int) -> torch.Tensor:
    """``gather_sum`` of ``cols`` (B, n_in + 1) that already end in the
    zero column ``n_in``."""
    out = torch.zeros((cols.shape[0], size), dtype=cols.dtype, device=cols.device)
    if len(entries):
        acc = cols[:, gather[:, 0]]
        for c in range(1, gather.shape[1]):
            acc = acc + cols[:, gather[:, c]]
        out[:, entries] = acc
    return out


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
