"""Connected-component decomposition of a constraint system.

The PyTorch counterpart of ``ezpz_tpu/models/blocks.py`` (its
``connected_components`` and ``build_buckets``). Big sketches are usually
unions of small independent subsystems — the reference's
``massive_parallel_system`` is 600 independent blocks — so the constraint
graph is split into connected components, components are bucketed by
identical topology, and each bucket is solved as one batch with
per-component parameters.

On top of the buckets, as in the JAX package:

* ``BlockSolver`` (and ``solve_blocks``): one ``BatchSolver`` per bucket,
  in any of its modes (the fleet kernels included), with the parameters
  and gather/scatter maps on the device once;
* ``BlockProgram``: the public API's decomposed drop-in for a
  ``(CompiledSystem, make_solver(...))`` pair: a ``BlockSolver`` whose
  tolerances come with each call, the same packed outcome, and the
  freedom analysis with global thresholds.

Semantics: each component runs its own LM loop (per-component lambda and
convergence); ``iterations`` is the max over components.

The union-find runs in the native C++ extension
(``native/fastdecomp.cpp``) when it builds, and in Python
(``_component_roots_python``) otherwise, with identical results.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..batch import BatchSolver
from ..config import Config
from ..constraints import Constraint, KernelInstance
from ..dof import TOLERANCE_BASE
from ..outcomes import FreedomAnalysis
from ..solver import pack_result, resolve_device, unpack_solver_result
from ..utils.errors import EmptySystemNotAllowed
from .compiled import CompiledSystem, compile_system


@dataclass
class Component:
    """One connected component: constraint indices + its variable ids."""

    constraint_ids: List[int]
    var_ids: List[int]  # global ids, sorted
    local_of_global: Dict[int, int]


def connected_components(
    constraints: Sequence[Constraint], n_vars: int
) -> List[Component]:
    """Union-find over the variable-sharing graph, components ordered by
    their first constraint id.

    Delegates the find/union sweep to the native C++ extension
    (``native/fastdecomp.cpp``) when available — the host-side bottleneck
    for million-constraint systems — with an identical-result Python
    fallback."""
    deps: List[List[int]] = [c.dependent_variable_ids() for c in constraints]
    roots = _component_roots_native(deps, n_vars)
    if roots is None:
        roots = _component_roots_python(deps, n_vars)
    var_root, cons_root = roots

    groups: Dict[int, Component] = {}
    for cid, root in enumerate(cons_root):
        if root < 0:
            root = -1  # constraints with no variables group together
        comp = groups.get(root)
        if comp is None:
            comp = Component(constraint_ids=[], var_ids=[], local_of_global={})
            groups[root] = comp
        comp.constraint_ids.append(cid)

    root_vars: Dict[int, set] = defaultdict(set)
    for vid in range(n_vars):
        r = var_root[vid]
        if r >= 0:
            root_vars[r].add(vid)
    for root, comp in groups.items():
        comp.var_ids = sorted(root_vars.get(root, ()))
        comp.local_of_global = {g: i for i, g in enumerate(comp.var_ids)}

    return sorted(groups.values(), key=lambda c: c.constraint_ids[0])


def _component_roots_python(deps, n_vars):
    """(var_root, cons_root) — Python union-find (fallback)."""
    parent = list(range(n_vars))

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    seen = [False] * n_vars
    for ids in deps:
        for vid in ids:
            seen[vid] = True
        for other in ids[1:]:
            ra, rb = find(ids[0]), find(other)
            if ra != rb:
                parent[rb] = ra
    var_root = [find(v) if seen[v] else -1 for v in range(n_vars)]
    cons_root = [find(ids[0]) if ids else -1 for ids in deps]
    return var_root, cons_root


def _component_roots_native(deps, n_vars):
    """(var_root, cons_root) via the C++ extension, or None."""
    from ..native import load_fastdecomp

    mod = load_fastdecomp()
    if mod is None:
        return None
    offsets = np.zeros(len(deps) + 1, dtype=np.int32)
    for i, ids in enumerate(deps):
        offsets[i + 1] = offsets[i] + len(ids)
    flat = np.fromiter(
        (v for ids in deps for v in ids), dtype=np.int32, count=int(offsets[-1])
    )
    vr_bytes, cr_bytes = mod.components(n_vars, offsets, flat)
    var_root = np.frombuffer(vr_bytes, dtype=np.int32)
    cons_root = np.frombuffer(cr_bytes, dtype=np.int32)
    return var_root.tolist(), cons_root.tolist()


def _component_signature(
    comp: Component, constraints: Sequence[Constraint], weights: Sequence[float]
) -> tuple:
    """Topology signature: lowered kernel sequences with local variable ids,
    weights included, parameters excluded (they batch)."""
    items = []
    for cid in comp.constraint_ids:
        for inst in constraints[cid].lower():
            local = tuple(comp.local_of_global[v] for v in inst.var_ids)
            items.append((inst.kernel, local, weights[cid]))
    return tuple(items)


@dataclass
class Bucket:
    """Components sharing one topology, solvable as a single batch."""

    system: CompiledSystem  # compiled with local ids for the template
    components: List[Component]
    pars: Tuple[np.ndarray, ...]  # per-block (B, n_k, np_k)
    var_index: np.ndarray  # (B, n_local) gather/scatter map to global x
    cid_index: np.ndarray  # (B, n_local_constraints) map to global cids


def build_buckets(
    constraints: Sequence[Constraint],
    n_vars: int,
    weights: Optional[Sequence[float]] = None,
    dtype: torch.dtype = torch.float64,
) -> List[Bucket]:
    """Components grouped by topology signature, buckets in the JAX
    package's order (signatures sorted by their string form)."""
    if weights is None:
        weights = [1.0] * len(constraints)
    comps = connected_components(constraints, n_vars)
    by_sig: Dict[tuple, List[Component]] = defaultdict(list)
    for comp in comps:
        by_sig[_component_signature(comp, constraints, weights)].append(comp)

    buckets: List[Bucket] = []
    for sig in sorted(by_sig.keys(), key=lambda s: str(s)):
        group = by_sig[sig]
        template = group[0]

        # Remap the *lowered* instances of the template to local ids: only
        # the ids a kernel actually gathers.
        local_constraints = []
        local_weights = []
        for cid in template.constraint_ids:
            insts = tuple(
                KernelInstance(
                    inst.kernel,
                    tuple(template.local_of_global[v] for v in inst.var_ids),
                    inst.params,
                )
                for inst in constraints[cid].lower()
            )
            local_constraints.append(_Lowered(insts))
            local_weights.append(weights[cid])
        system = compile_system(
            local_constraints, n_vars=len(template.var_ids),
            weights=local_weights, dtype=dtype,
        )

        # Every component's lowered params, stacked in the template's block
        # order (components share the signature, so the order matches).
        pars_per_comp = []
        for comp in group:
            by_kind: Dict[str, List[tuple]] = defaultdict(list)
            for cid in comp.constraint_ids:
                for inst in constraints[cid].lower():
                    by_kind[inst.kernel].append(inst.params)
            pars_per_comp.append(by_kind)
        pars = []
        for b in system.blocks:
            stacked = np.stack(
                [
                    np.asarray(pc[b.spec.name], dtype=np.float64).reshape(
                        len(pc[b.spec.name]), b.spec.nparams
                    )
                    for pc in pars_per_comp
                ]
            )
            pars.append(stacked)

        var_index = np.stack([np.asarray(c.var_ids, dtype=np.int32) for c in group])
        cid_index = np.stack(
            [np.asarray(c.constraint_ids, dtype=np.int32) for c in group]
        )
        buckets.append(
            Bucket(
                system=system,
                components=group,
                pars=tuple(pars),
                var_index=var_index,
                cid_index=cid_index,
            )
        )
    return buckets


class _Lowered:
    """Pre-lowered constraint: satisfies the ``.lower()`` protocol that
    ``compile_system`` consumes."""

    __slots__ = ("instances",)

    def __init__(self, instances):
        self.instances = instances

    def lower(self):
        return list(self.instances)


@dataclass
class BlockSolveResult:
    x: np.ndarray  # (n_vars,) final values
    iterations: int  # max over components (the reference reports one number)
    converged: bool  # all components converged
    satisfied: np.ndarray  # (n_constraints,) bool
    degenerate: np.ndarray  # (n_constraints,) bool
    n_components: int
    n_buckets: int


class BlockSolver:
    """A reusable decomposed solver on ``device`` (the card unless the
    caller names another): buckets, per-bucket ``BatchSolver``s, batched
    parameters and the gather/scatter maps are built once, on the device;
    ``solve_packed(x0)`` gathers, solves every bucket and scatters on the
    device into one packed tensor, which ``solve(x0)`` copies to the host
    once.

    ``precision``, ``pallas_coarse`` and ``pallas_fused`` select the
    ``BatchSolver`` mode of every bucket; the kernel modes apply only with
    ``precision="mixed"`` (as in the JAX package), and each bucket the
    kernel gate refuses takes the batched mixed path. The default stays
    the reference-exact f64 loop."""

    def __init__(
        self,
        constraints: Sequence[Constraint],
        n_vars: int,
        weights: Optional[Sequence[float]] = None,
        config: Config = Config(),
        precision: str = "f64",
        pallas_coarse: bool = False,
        pallas_fused: bool = False,
        device=None,
    ):
        dev = self.device = resolve_device(device)
        self.n_vars = n_vars
        self.n_constraints = len(constraints)
        self.config = config
        self.buckets = build_buckets(constraints, n_vars, weights)
        self.n_components = sum(len(b.components) for b in self.buckets)
        self._solvers = [
            BatchSolver(b.system, config, batch_params=True, precision=precision,
                        pallas_coarse=pallas_coarse and precision == "mixed",
                        pallas_fused=pallas_fused and precision == "mixed",
                        device=dev)
            for b in self.buckets
        ]
        self._pars = [tuple(torch.as_tensor(p, device=dev) for p in b.pars)
                      for b in self.buckets]
        # Per bucket, its gather/scatter maps to global variable and
        # constraint ids.
        self._maps = [(torch.as_tensor(b.var_index, dtype=torch.long, device=dev),
                       torch.as_tensor(b.cid_index, dtype=torch.long, device=dev))
                      for b in self.buckets]

    def solve_packed(self, x0, config: Optional[Config] = None) -> torch.Tensor:
        """Solve every bucket from ``x0`` (n_vars,) and return the packed
        outcome ``[x | sat | deg | converged | iterations]`` (the layout of
        ``make_solver``'s), still on the device. Each bucket gathers from
        ``x0``: buckets own disjoint variables. ``config``, when given,
        takes the place of the solver's own for this call."""
        x0 = torch.as_tensor(x0, dtype=torch.float64, device=self.device)
        x_out = x0.clone()
        sat = torch.ones(self.n_constraints, dtype=torch.bool, device=self.device)
        deg = torch.zeros_like(sat)
        iterations = torch.zeros((), dtype=torch.int32, device=self.device)
        converged = torch.ones((), dtype=torch.bool, device=self.device)
        for solver, pars, (gi, ci) in zip(self._solvers, self._pars, self._maps):
            res = solver.solve(x0[gi], pars, config=config)
            x_out[gi.reshape(-1)] = res.x.reshape(-1)
            sat[ci.reshape(-1)] = res.satisfied.reshape(-1)
            deg[ci.reshape(-1)] = res.degenerate.reshape(-1)
            iterations = torch.maximum(iterations, res.iterations.max())
            converged = converged & res.converged.all()
        return pack_result(x_out, sat, deg, converged, iterations)

    def solve(self, x0) -> BlockSolveResult:
        """Solve every bucket from ``x0`` (n_vars,), with one copy to the
        host."""
        x, sat, deg, converged, iterations = unpack_solver_result(
            self.solve_packed(x0).cpu().numpy(), self.n_vars, self.n_constraints)
        return BlockSolveResult(
            x=x,
            iterations=iterations,
            converged=converged,
            satisfied=sat,
            degenerate=deg,
            n_components=self.n_components,
            n_buckets=len(self.buckets),
        )


def solve_blocks(
    constraints: Sequence[Constraint],
    x0: np.ndarray,
    weights: Optional[Sequence[float]] = None,
    config: Config = Config(),
    device=None,
) -> BlockSolveResult:
    """One-shot convenience wrapper around ``BlockSolver``."""
    return BlockSolver(constraints, len(x0), weights, config, device=device).solve(x0)


class BlockProgram:
    """Decomposed drop-in for the public API's ``(CompiledSystem,
    make_solver(...))`` pair, on ``device`` (the card unless the caller
    names another).

    The reference exploits component sparsity through its sparse-LLT
    Newton step (``newton.rs:15``): K independent blocks factor in
    sum(n_k^3), not (sum n_k)^3. Here that sparsity is batching: components
    are grouped by topology (``build_buckets``) and each bucket runs ONE
    batched LM loop, bucket after bucket on one device: the program is a
    ``BlockSolver`` (plain f64 or mixed, no kernel mode) whose tolerances
    come with each call.

    ``solver`` returns the same packed outcome as ``make_solver``'s
    (``[x | sat | deg | converged | iterations]``, one device-to-host
    copy), so the API's cascade, the CLI and the pipelined timing protocol
    work the same on both paths. Per-component LM gives each block its own
    damping schedule and convergence test; ``iterations`` is the max over
    components. The API takes this path only past a component-count
    threshold (``api._decompose_min``), so small sketches keep the
    reference-exact global loop.
    """

    def __init__(
        self,
        constraints: Sequence[Constraint],
        n_vars: int,
        weights: Optional[Sequence[float]] = None,
        max_iterations: int = 50,
        precision: str = "f64",
        device=None,
    ):
        self._blocks = BlockSolver(constraints, n_vars, weights,
                                   Config(max_iterations=max_iterations),
                                   precision=precision, device=device)
        self.device = self._blocks.device
        self.n_vars = n_vars
        self.n_constraints = len(constraints)
        self.max_iterations = max_iterations
        self.buckets = self._blocks.buckets
        self.n_components = self._blocks.n_components

        # Every constraint must land in exactly one component (one with no
        # variables never would); the API takes the monolithic path when
        # coverage is incomplete.
        covered = np.zeros(self.n_constraints, dtype=bool)
        for b in self.buckets:
            covered[b.cid_index.reshape(-1)] = True
        self.complete = bool(covered.all())
        self.n_rows = int(sum(c.residual_dim() for c in constraints))

    def solver(self, x0, rtol, stol, lam0) -> torch.Tensor:
        """Same call signature and packed return as ``make_solver(...)``."""
        config = replace(self._blocks.config, residual_tolerance=rtol,
                         step_tolerance=stol, initial_lambda=lam0)
        return self._blocks.solve_packed(x0, config)

    def _bucket_jacobians(self, x):
        """Per bucket, its batched weighted Jacobians ``(B, m_local,
        n_local)`` at the global point ``x``, as host numpy."""
        x = torch.as_tensor(x, dtype=torch.float64, device=self.device)
        return [b.system.jacobian_dense(x[gi], pk).cpu().numpy()
                for b, pk, (gi, _ci) in zip(self.buckets, self._blocks._pars,
                                            self._blocks._maps)]

    def jacobian_dense(self, x) -> np.ndarray:
        """Global weighted dense Jacobian at ``x`` (host numpy), assembled
        from the per-bucket batched Jacobians. Rows are grouped by bucket,
        not constraint id; the freedom analysis is row-order-invariant."""
        out = np.zeros((self.n_rows, self.n_vars), dtype=np.float64)
        row = 0
        for b, jb in zip(self.buckets, self._bucket_jacobians(x)):
            B, m_local, _ = jb.shape
            rows = row + np.arange(B * m_local).reshape(B, m_local)
            out[rows[:, :, None], b.var_index[:, None, :]] = jb
            row += B * m_local
        return out

    def freedom_analysis(self, x):
        """Freedom analysis from per-bucket batched SVDs (host numpy, as the
        JAX package computes it). Exact: the global Jacobian is
        block-diagonal up to a permutation, so its singular values are the
        union of the blocks' and the nullspace projector (whose diagonal is
        the participation) is block-diagonal. Both reference thresholds
        stay GLOBAL: the rank cut 1e-8 * the largest singular value across
        blocks (find_dof.rs:40-47) and the participation cut 1e-3 * the
        largest participation. A guessed-but-unconstrained variable is a
        zero column: participation exactly 1."""
        if self.n_rows == 0 or self.n_vars == 0:
            raise EmptySystemNotAllowed()

        svals, vts = [], []
        for jb in self._bucket_jacobians(x):
            _u, s, vt = np.linalg.svd(jb, full_matrices=True)
            svals.append(s)
            vts.append(vt)

        largest = max((float(s.max()) for s in svals if s.size), default=0.0)
        tol = TOLERANCE_BASE * largest
        participation = np.ones(self.n_vars, dtype=np.float64)  # zero columns
        for b, s, vt in zip(self.buckets, svals, vts):
            rank = (s > tol).sum(axis=1)  # (B,)
            n_local = vt.shape[2]
            null_rows = np.arange(n_local)[None, :] >= rank[:, None]
            part = np.einsum("bji,bji->bi", vt * null_rows[:, :, None], vt)
            participation[b.var_index] = part

        max_participation = float(participation.max()) if self.n_vars else 0.0
        var_tol = 1e-3 * max_participation
        squared = var_tol * var_tol
        under = [int(i) for i in range(self.n_vars) if participation[i] > squared]
        return FreedomAnalysis(under)
