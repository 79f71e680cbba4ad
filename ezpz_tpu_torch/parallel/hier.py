"""Preconditioned conjugate gradients over a batch of lanes.

``_pcg`` of ``ezpz_tpu/parallel/hier.py``, the boundary solve of
``BlockSchurSolver(boundary_solver="cg")``. ``ShardedBlockSchurSolver``
itself is not ported yet (ROADMAP.md queue 1 item 9).
"""

from __future__ import annotations

import torch


def _pcg(matvec, b, minv_diag, tol, max_iters):
    """Jacobi-preconditioned CG on every lane of ``b`` (B, n): ``matvec``
    maps (B, n) to (B, n), ``minv_diag`` (B, n) is the elementwise inverse
    preconditioner and ``tol`` (B,) the absolute tolerance on each lane's
    residual norm.

    Each lane stops where its own ``lax.while_loop`` would (``|r|^2 >
    tol^2`` and fewer than ``max_iters`` iterations): a trip computes every
    lane and keeps the new state only on the lanes still running, as
    ``vmap`` of the JAX loop does. One host sync per trip."""
    x = torch.zeros_like(b)
    r = b
    z = minv_diag * r
    p = z
    rz = torch.sum(r * z, dim=-1)
    it = torch.zeros(b.shape[:-1], dtype=torch.int32, device=b.device)
    while True:
        live = (torch.sum(r * r, dim=-1) > tol * tol) & (it < max_iters)
        if not bool(live.any()):
            return x
        ap = matvec(p)
        alpha = rz / torch.sum(p * ap, dim=-1)
        x_n = x + alpha[:, None] * p
        r_n = r - alpha[:, None] * ap
        z_n = minv_diag * r_n
        rz_n = torch.sum(r_n * z_n, dim=-1)
        p_n = z_n + (rz_n / rz)[:, None] * p
        keep = live[:, None]
        x, r, z, p = (torch.where(keep, a, c) for a, c in
                      ((x_n, x), (r_n, r), (z_n, z), (p_n, p)))
        rz = torch.where(live, rz_n, rz)
        it = torch.where(live, it + 1, it)
