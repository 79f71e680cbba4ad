"""Preconditioned conjugate gradients over a batch of lanes.

``_pcg`` of ``ezpz_tpu/parallel/hier.py``, the boundary solve of
``BlockSchurSolver(boundary_solver="cg")``. ``ShardedBlockSchurSolver``
itself is not ported yet (ROADMAP.md queue 1 item 9).
"""

from __future__ import annotations

from ..solver import _cg


def _pcg(matvec, b, minv_diag, tol, max_iters):
    """Jacobi-preconditioned CG on every lane of ``b`` (B, n) from zero:
    ``matvec`` maps (B, n) to (B, n), ``minv_diag`` (B, n) is the
    elementwise inverse preconditioner and ``tol`` (B,) the absolute
    tolerance on each lane's residual norm. Each lane stops where its own
    ``lax.while_loop`` would; one host sync per trip (``solver._cg``)."""
    return _cg(matvec, b, None, tol, max_iters, minv_diag)
