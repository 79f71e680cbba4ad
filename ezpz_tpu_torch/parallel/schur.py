"""Partitioning helpers of the partitioned-Schur solvers.

The host-side (numpy) part of ``ezpz_tpu/parallel/schur.py``:
``partition_variables`` and ``resolve_boundary_solver``, shared by every
Schur solver. ``ShardedSchurSolver`` itself is not ported yet (ROADMAP.md
queue 1 item 9).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..constraints import Constraint


def resolve_boundary_solver(requested: str, n_b: int, band_bw: int) -> str:
    """Resolve ``boundary_solver="auto"`` from the coupling structure, all
    known at build time (the JAX package's rule):

    * ``banded`` when the Schur complement's half-bandwidth is a small
      fraction of ``n_b`` (chain-like coupling: ``4*(bw+1) <= n_b``): an
      exact direct solve in O(n_b*bw^2);
    * ``dense`` for small boundaries (``n_b <= 256``): one Cholesky of a
      small matrix, the step exact;
    * ``cg`` otherwise: Jacobi-PCG matvecs never materialise S; the LM
      accept/reject loop absorbs the inexact step.
    """
    if requested != "auto":
        return requested
    if n_b > 0 and band_bw > 0 and 4 * (band_bw + 1) <= n_b:
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
