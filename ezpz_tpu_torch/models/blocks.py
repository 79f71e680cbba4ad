"""Connected-component decomposition of a constraint system.

The PyTorch counterpart of ``ezpz_tpu/models/blocks.py`` (its
``connected_components`` and ``build_buckets``). Big sketches are usually
unions of small independent subsystems — the reference's
``massive_parallel_system`` is 600 independent blocks — so the constraint
graph is split into connected components, components are bucketed by
identical topology, and each bucket is solved as one batch with
per-component parameters.

The union-find is the JAX package's pure-Python one
(``_component_roots_python``); its native C++ twin is not part of this
package yet.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constraints import Constraint, KernelInstance
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
    their first constraint id."""
    deps: List[List[int]] = [c.dependent_variable_ids() for c in constraints]
    var_root, cons_root = _component_roots_python(deps, n_vars)

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
    """(var_root, cons_root) — Python union-find."""
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
