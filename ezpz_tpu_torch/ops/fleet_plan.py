"""Build-time planner for the fleet kernels.

A copy of the pure-Python planner in ``ezpz_tpu/ops/pallas_fleet.py``
(``_instance_list``, the JtJ pattern, the symbolic fill, the RCM and
nested-dissection orderings, ``_plan_factorization``, ``jtj_fill_count``,
``n_flag_words``) and of the JAX ``BatchSolver``'s kernel gate
(``kernel_admits``), plus ``plan_fleet``, which turns a topology into the
plain tables the CUDA kernels and their plain versions read: the instance
table in the elimination numbering, the factor packed by the planned
fill, and the Crout and triangular-solve schedules. No array math runs
here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.compiled import CompiledSystem
from .kernels import KIND_ID


def _instance_list(system: CompiledSystem):
    """(kernel name, ids, block_idx, inst_idx, p_k, weight, cid) per
    lowered instance, in residual-row order (weight as Python float)."""
    out = []
    for bi, b in enumerate(system.blocks):
        pk = int(b.par.shape[1])
        for i in range(b.idx.shape[0]):
            out.append((
                b.spec.name,
                [int(j) for j in b.idx[i]],
                bi, i, pk,
                float(b.weight[i]),
                int(b.cid[i]),
            ))
    return out


# -- static JtJ sparsity + symbolic Cholesky fill ------------------------------
#
# The fused kernel factors the damped normal matrix by Crout restricted to
# the factor's structural nonzeros (a chained sketch's JtJ is banded). The
# JtJ nonzero pattern follows from the static instance variable ids, its
# Cholesky fill-in from the classic symbolic factorization; both the CUDA
# kernel and the plain version skip every entry outside the fill pattern
# (exact zeros in the dense computation, so NaN propagation matches the
# JAX kernel's).


def _jtj_pattern(instances, n):
    """Lower-triangular nonzero pattern {(i, j), i >= j} of JtJ from the
    static instance variable ids. The diagonal is always present (the LM
    damping lands there)."""
    pat = {(i, i) for i in range(n)}
    for inst in instances:
        ids = inst[1]
        for a in ids:
            for b in ids:
                if a >= b:
                    pat.add((a, b))
    return pat


def _etree_fill(pat, n, limit=None):
    """Structural Cholesky fill via the elimination-tree row-subtree
    traversal (Davis, *Direct Methods for Sparse Linear Systems* §4.1):
    the pattern of row ``i`` of L is the set of nodes reached by walking
    each ``k`` with ``A[i][k] != 0, k < i`` up the etree until hitting a
    node already marked for row ``i``. Every marked node is one structural
    nonzero of L, so the whole analysis costs O(nnz(L)) — the O(n^3)
    triple-loop this replaced made a mistakenly-routed 2,400-var topology
    spend minutes planning before the eligibility gate could decline it.

    ``pat`` is the lower-triangular A pattern (diagonal included — always
    true for ``_jtj_pattern``, whose diagonal carries the LM damping).
    Returns ``(count, rows)``: the factor's nonzero count (diagonal
    included) and per-row off-diagonal column bitmasks. With ``limit``,
    bails out as soon as ``count`` exceeds it and returns
    ``(limit + 1, None)`` — eligibility gating needs only "over the cap",
    never the pattern of an over-cap topology.
    """
    lower = [[] for _ in range(n)]
    for i, j in pat:
        if i != j:
            lower[i].append(j)
    parent = [-1] * n
    visited = [-1] * n
    rows = [0] * n
    count = n  # the diagonal is always structurally present
    if limit is not None and count > limit:
        return limit + 1, None
    for i in range(n):
        visited[i] = i
        for k in lower[i]:
            j = k
            while visited[j] != i:
                visited[j] = i
                rows[i] |= 1 << j
                count += 1
                if limit is not None and count > limit:
                    return limit + 1, None
                if parent[j] == -1:
                    parent[j] = i
                j = parent[j]
    return count, rows


def _symbolic_fill(pat, n):
    """Cholesky fill-in: nzL[i][j] (j <= i) is True iff L[i][j] is
    structurally nonzero — A's pattern plus fill (L[i][k] and L[j][k] both
    nonzero for some k < j). Computed by ``_etree_fill`` (identical closure
    to the Crout recurrence, Parter/Rose theorem; oracle-tested against a
    numeric factorization in tests/test_ds_fused.py)."""
    _count, rows = _etree_fill(pat, n)
    nzL = [[False] * n for _ in range(n)]
    for i in range(n):
        nzL[i][i] = True
        r = rows[i]
        while r:
            j = (r & -r).bit_length() - 1
            nzL[i][j] = True
            r &= r - 1
    return nzL


def _rcm_order(pat, n):
    """Reverse Cuthill-McKee ordering of the JtJ adjacency graph. Returns
    ``perm`` (position k holds the original variable index eliminated
    k-th). Classic bandwidth-reducing heuristic: BFS from a minimum-degree
    vertex per component, neighbors visited in increasing-degree order,
    then reverse."""
    adj = [set() for _ in range(n)]
    for i, j in pat:
        if i != j:
            adj[i].add(j)
            adj[j].add(i)
    deg = [len(a) for a in adj]
    visited = [False] * n
    order = []
    for start in sorted(range(n), key=lambda v: (deg[v], v)):
        if visited[start]:
            continue
        visited[start] = True
        queue = [start]
        qi = 0
        while qi < len(queue):
            v = queue[qi]
            qi += 1
            order.append(v)
            for w in sorted(adj[v], key=lambda u: (deg[u], u)):
                if not visited[w]:
                    visited[w] = True
                    queue.append(w)
    order.reverse()
    return order


def _nd_order(pat, n, leaf=12):
    """Nested-dissection ordering of the JtJ adjacency graph: recursively
    split each connected subgraph with a BFS level-set separator (the
    minimum-size, balance-weighted level in the middle half from a
    pseudo-peripheral start, thinned to vertices that actually touch the
    far side), order the halves first and the separator last. Returns the
    same convention as ``_rcm_order``: position k holds the original
    variable index eliminated k-th.

    This is the classic fill heuristic for 2-D grid-like topologies: a
    k x k grid's band is width O(k) (RCM fill O(k^3)) while ND fill is
    O(k^2 log k) — measured on the rect_grid fixtures it beats RCM from
    5x5 up (704 vs 728 at 72 vars, 3479 vs 4103 at 242 vars) and loses
    on chains, where the strict-improvement acceptance in
    ``_plan_factorization`` keeps RCM."""
    adj = [set() for _ in range(n)]
    for i, j in pat:
        if i != j:
            adj[i].add(j)
            adj[j].add(i)

    def comps(vs):
        seen, out = set(), []
        for v in sorted(vs):
            if v in seen:
                continue
            comp, stack = {v}, [v]
            seen.add(v)
            while stack:
                u = stack.pop()
                for w in sorted(adj[u]):
                    if w in vs and w not in seen:
                        seen.add(w)
                        comp.add(w)
                        stack.append(w)
            out.append(comp)
        return out

    def bfs_levels(vs, start):
        level = {start: 0}
        frontier = [start]
        levels = [[start]]
        while frontier:
            nxt = []
            for v in frontier:
                for w in sorted(adj[v]):
                    if w in vs and w not in level:
                        level[w] = level[v] + 1
                        nxt.append(w)
            if nxt:
                levels.append(nxt)
            frontier = nxt
        return levels

    def dissect_conn(comp):
        if len(comp) <= leaf:
            return sorted(comp)
        # Pseudo-peripheral start: BFS from a min-degree vertex, restart
        # from the farthest level's min-degree vertex.
        start = min(comp, key=lambda v: (len(adj[v] & comp), v))
        levels = bfs_levels(comp, start)
        start = min(levels[-1], key=lambda v: (len(adj[v] & comp), v))
        levels = bfs_levels(comp, start)
        L = len(levels)
        if L < 3:
            return sorted(comp)  # clique-like: no useful separator
        sizes = [len(lv) for lv in levels]
        pre = [0]
        for s in sizes:
            pre.append(pre[-1] + s)
        total = pre[-1]
        best, best_cost = None, None
        for mid in range(max(1, L // 4), min(L - 1, (3 * L) // 4 + 1)):
            a_sz, b_sz = pre[mid], total - pre[mid + 1]
            if a_sz == 0 or b_sz == 0:
                continue
            cost = sizes[mid] * (1.0 + abs(a_sz - b_sz) / total)
            if best_cost is None or cost < best_cost:
                best, best_cost = mid, cost
        if best is None:
            return sorted(comp)
        sep = set(levels[best])
        a = set().union(*levels[:best])
        b = comp - sep - a
        # Thin the separator: a level vertex with no edge into the far
        # half separates nothing — fold it into the near half.
        keep = {v for v in sep if adj[v] & b}
        a |= sep - keep
        return dissect(a) + dissect(b) + sorted(keep)

    def dissect(vs):
        out = []
        for c in comps(vs):
            out += dissect_conn(c)
        return out

    return dissect(set(range(n)))


def _permuted_pattern(pat, perm, n):
    """``pat`` relabeled so position ``k`` holds variable ``perm[k]``."""
    inv = [0] * n
    for k, v in enumerate(perm):
        inv[v] = k
    return {(max(inv[i], inv[j]), min(inv[i], inv[j])) for (i, j) in pat}


def _candidate_orders(pat, n):
    """The elimination orderings the planner considers, best-first on
    ties: identity (None — preserves bit-exact dense-unroll equivalence
    for well-ordered topologies), then RCM (bands/chains), then nested
    dissection (2-D grids)."""
    return [None, _rcm_order(pat, n), _nd_order(pat, n)]


def _plan_factorization(instances, n):
    """(perm, nzL): the elimination plan for this topology's JtJ.

    The kernel's variable numbering comes from declaration order, which a
    user can shuffle arbitrarily — a zigzag-declared chain has a banded
    GRAPH but a dense-looking numbering, and symbolic fill explodes. Try
    every candidate ordering (identity, RCM) and keep the first one
    achieving the minimum symbolic nonzero count — so a reordering is
    accepted only when it STRICTLY reduces fill (ties keep identity,
    preserving the bit-exact dense-unroll equivalence for
    already-well-ordered topologies). ``perm`` is None for identity."""
    pat = _jtj_pattern(instances, n)
    best_perm, best_count = None, None
    for perm in _candidate_orders(pat, n):
        p = pat if perm is None else _permuted_pattern(pat, perm, n)
        count, _rows = _etree_fill(p, n)
        if best_count is None or count < best_count:
            best_perm, best_count = perm, count
    p = pat if best_perm is None else _permuted_pattern(pat, best_perm, n)
    return best_perm, _symbolic_fill(p, n)


def jtj_fill_count(system: CompiledSystem, limit=None) -> int:
    """Lower-triangular structural nonzero count of the Cholesky factor of
    this topology's JtJ (diagonal included), fill-in included, under the
    elimination ordering the kernel will actually use (the least-filling
    candidate, see ``_plan_factorization``).

    ``limit``: early-exit bound for gating callers — the count is exact
    whenever it is <= limit, and any value > limit is reported as
    ``limit + 1`` without finishing the analysis (each candidate
    ordering's traversal stops at the cap, so even a huge mistakenly-
    routed topology answers in O(n + candidates * limit))."""
    n = system.n_vars
    pat = _jtj_pattern([
        (None, [int(j) for j in b.idx[i]])
        for b in system.blocks
        for i in range(b.idx.shape[0])
    ], n)
    best = None
    for perm in _candidate_orders(pat, n):
        p = pat if perm is None else _permuted_pattern(pat, perm, n)
        count, _rows = _etree_fill(p, n, limit=limit)
        if best is None or count < best:
            best = count
    return best


# The kernel gate of the JAX BatchSolver (ezpz_tpu/batch.py:57-58): a
# topology goes to the fleet kernels when it has at most this many
# instances and a planned factor fill of at most dense-64's.
KERNEL_MAX_FILL = 64 * 65 // 2
KERNEL_MAX_INSTANCES = 256


def _within_gate(n_instances: int, fill) -> bool:
    """The kernel gate: at most ``KERNEL_MAX_INSTANCES`` instances and a
    planned fill (``fill()``, asked only when the count passes) of at most
    ``KERNEL_MAX_FILL``."""
    return 0 < n_instances <= KERNEL_MAX_INSTANCES and fill() <= KERNEL_MAX_FILL


def kernel_admits(system: CompiledSystem) -> bool:
    """Whether the fleet kernels take ``system`` (``BatchSolver.
    _pallas_topology_ok`` of the JAX package, in its order: the instance
    count first, so an oversized topology is declined before the symbolic
    planner runs, and the fill analysis stops at the cap)."""
    return _within_gate(sum(int(b.idx.shape[0]) for b in system.blocks),
                        lambda: jtj_fill_count(system, limit=KERNEL_MAX_FILL))


def n_flag_words(n_cons: int) -> int:
    """i32 words per lane needed to carry one bit per constraint."""
    return max(1, (n_cons + 31) // 32)


# -- tables for the kernel -----------------------------------------------------

# Columns of the int32 instance table (one row per lowered instance).
INST_KIND, INST_NV, INST_DIM, INST_CID, INST_POFF, INST_PK = range(6)
INST_IDS = 6  # ids occupy columns INST_IDS .. INST_IDS + MAX_NV - 1
MAX_NV = 8
INST_COLS = INST_IDS + MAX_NV

# Columns of the kernels' int32 instance table (csrc/fleet_common.cuh,
# KI_*): kind, rows, variable count, parameter offset, flag word and bit
# of the constraint, parameter count, the variables in the elimination
# numbering (-1 padded), then 64 int16 factor slots, one per variable
# pair (a, b), -1 where the pair adds nothing to the factor.
KI_KIND, KI_DIM, KI_NV, KI_POFF, KI_WORD, KI_BIT, KI_PK = range(7)
KI_IDS = 8
KI_SLOTS = 16
KI_COLS = KI_SLOTS + MAX_NV * MAX_NV // 2


@dataclass(frozen=True)
class FleetPlan:
    """One topology as the tables the fused kernel reads.

    ``inst``: (n_inst, INST_COLS) int32 — kind id (``kernels.KIND_ID``),
    var count, row count, constraint id, offset of the instance's
    parameters inside a sketch's concatenated parameter row, parameter
    count, var ids (-1 padded). ``w64``/``w32``: (n_inst,) weights.
    ``perm``: (n,) int32 elimination order (identity when the planner kept
    it). ``nzl``: (n, n) uint8, the factor's structural nonzeros in the
    permuted numbering (lower triangle). ``par_cols``: per block, the
    ``(offset, nk * pk)`` columns of the concatenated parameter row.

    ``kernel``: None when the kernel gate (``kernel_admits``) declines the
    topology, else the kernels' tables (``kernel_tables``): ``kinst`` (n_inst, KI_COLS) int32, the factor's
    packing (slot of each structural nonzero, row-major) as ``row_start``
    and ``ent_col``, the Crout schedule ``cr_start``/``cr_pair``, the
    backward solve's column lists ``col_start``/``col_ent``, ``fill_bits``
    (bit ``i(i+1)/2 + j`` per nonzero, for n <= 8) and ``distinct_ids``
    (no instance names a variable twice).
    """

    n_vars: int
    n_rows: int
    n_constraints: int
    inst: np.ndarray
    w64: np.ndarray
    w32: np.ndarray
    perm: np.ndarray
    nzl: np.ndarray
    par_cols: tuple
    n_par: int
    kernel: dict = None
    _tables: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def n_inst(self) -> int:
        return int(self.inst.shape[0])

    @property
    def fill(self) -> int:
        return int(self.nzl.sum())

    def big_tables(self) -> tuple:
        """The tables the big-topology kernels read, in their argument
        order: kinst, w32, w64, perm, row_start, ent_col, cr_start,
        cr_pair, col_start, col_ent."""
        k = self.kernel
        return (k["kinst"], self.w32, self.w64, self.perm, k["row_start"],
                k["ent_col"], k["cr_start"], k["cr_pair"], k["col_start"],
                k["col_ent"])

    def device_tables(self, device):
        """``big_tables`` as tensors on ``device``, uploaded once per
        device. Threads that upload at once keep the first stored copy
        (``setdefault``), so every launch reads the tables the cache holds."""
        key = str(device)
        if key not in self._tables:
            self._tables.setdefault(key, tuple(torch.as_tensor(a).to(device)
                                               for a in self.big_tables()))
        return self._tables[key]


def plan_fleet(system: CompiledSystem) -> FleetPlan:
    """The kernel tables for ``system`` (see ``FleetPlan``)."""
    n = system.n_vars
    instances = _instance_list(system)
    par_cols, off = [], 0
    for b in system.blocks:
        width = int(b.idx.shape[0]) * int(b.par.shape[1])
        par_cols.append((off, width))
        off += width
    inst = np.full((len(instances), INST_COLS), -1, np.int32)
    for row, (name, ids, bi, i, pk, _w, cid) in enumerate(instances):
        if len(ids) > MAX_NV:
            raise ValueError(f"{name}: {len(ids)} vars > {MAX_NV}")
        spec = system.blocks[bi].spec
        inst[row, :INST_IDS] = (KIND_ID[name], len(ids), spec.dim, cid,
                                par_cols[bi][0] + i * pk, pk)
        inst[row, INST_IDS:INST_IDS + len(ids)] = ids
    w64 = np.asarray([t[5] for t in instances], np.float64)
    perm, nz = _plan_factorization([(None, t[1]) for t in instances], n)
    perm = np.asarray(range(n) if perm is None else perm, np.int32)
    nzl = np.asarray(nz, np.uint8).reshape(n, n)
    admitted = _within_gate(len(instances), lambda: int(nzl.sum()))
    return FleetPlan(
        n_vars=n,
        n_rows=system.n_rows,
        n_constraints=system.n_constraints,
        inst=inst,
        w64=w64,
        w32=w64.astype(np.float32),
        perm=perm,
        nzl=nzl,
        par_cols=tuple(par_cols),
        n_par=off,
        kernel=kernel_tables(inst, perm, nzl) if admitted else None,
    )


def kernel_tables(inst: np.ndarray, perm: np.ndarray, nzl: np.ndarray) -> dict:
    """The kernels' view of a plan (see ``FleetPlan``): everything in the
    elimination numbering, the factor packed row by row over its
    structural nonzeros, and the Crout factorization and both triangular
    solves as lists of slots in the order the plain version
    (``fleet_common.damped_solve``) visits them."""
    n = int(perm.shape[0])
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    rows = [[j for j in range(i + 1) if nzl[i, j]] for i in range(n)]
    slot = {}
    row_start = [0]
    for i, cols in enumerate(rows):
        for j in cols:
            slot[i, j] = len(slot)
        row_start.append(len(slot))
    ent_col = [j for cols in rows for j in cols]
    sets = [set(cols) for cols in rows]
    cr_start, cr_pair = [0], []
    for i, cols in enumerate(rows):
        for j in cols:
            for k in sorted(k for k in sets[i] & sets[j] if k < j):
                cr_pair.append(slot[i, k] | slot[j, k] << 16)
            cr_start.append(len(cr_pair))
    col_start, col_ent = [0], []
    for i in range(n):
        col_ent += [slot[k, i] | k << 16 for k in range(i + 1, n) if nzl[k, i]]
        col_start.append(len(col_ent))

    kinst = np.zeros((inst.shape[0], KI_COLS), np.int32)
    slots = np.full((inst.shape[0], MAX_NV * MAX_NV), -1, np.int16)
    distinct = True
    for row, rec in enumerate(inst):
        nv, cid = int(rec[INST_NV]), int(rec[INST_CID])
        ids = [int(inv[j]) for j in rec[INST_IDS:INST_IDS + nv]]
        distinct = distinct and len(set(ids)) == nv
        kinst[row, :KI_IDS] = (rec[INST_KIND], rec[INST_DIM], nv, rec[INST_POFF],
                               cid >> 5, np.uint32(1 << (cid & 31)).view(np.int32),
                               rec[INST_PK], 0)
        kinst[row, KI_IDS:KI_SLOTS] = ids + [-1] * (MAX_NV - nv)
        for a, pa in enumerate(ids):
            for b, pb in enumerate(ids):
                if pa >= pb:
                    slots[row, a * MAX_NV + b] = slot[pa, pb]
    kinst[:, KI_SLOTS:] = slots.view(np.int32)
    fill_bits = 0
    if n <= MAX_NV:
        for (i, j) in slot:
            fill_bits |= 1 << (i * (i + 1) // 2 + j)
    as32 = lambda v: np.asarray(v, np.int32)  # noqa: E731
    return dict(kinst=kinst, row_start=as32(row_start), ent_col=as32(ent_col),
                cr_start=as32(cr_start), cr_pair=as32(cr_pair),
                col_start=as32(col_start), col_ent=as32(col_ent),
                fill_bits=fill_bits, distinct_ids=distinct)
