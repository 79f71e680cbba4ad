"""Batched SPD solves for the LM loop.

The PyTorch counterpart of ``ezpz_tpu/ops/linalg.py``'s ``spd_solve``.
Every function works over an explicit leading batch axis: ``A`` is
``(B, n, n)``, ``b`` is ``(B, n)``.

* n <= 24: the fully unrolled Cholesky-Crout over ``(B,)`` columns, in the
  JAX package's operation order (``_chol_unrolled``, ``_solve_unrolled``)
  with its NaN/zero-diagonal sanitising;
* n > 24: ``torch.linalg.cholesky_ex`` and ``torch.cholesky_solve``. A lane
  fails on ``info > 0`` or on a non-finite diagonal of the factor
  (``cholesky_ex`` does not always report NaN input through ``info``).

Failure semantics are the JAX package's everywhere: a numerically non-SPD
lane reports ``fail`` and a zero-filled, finite ``x``; the LM loop treats it
as a rejected step.

The JAX package's TPU size tiers are not ported: the banded scan
(``ops/banded.py``), the column sweep (``_midsize_spd_solve``) and the
blocked factorization exist because XLA's batched Cholesky is slow on a
TPU. Its per-topology routing (``batch._pick_spd``) and its heavily-batched
entry point (``spd_solve_batched``) both become ``spd_solve`` for every n.
"""

from __future__ import annotations

import torch

# Above this size the unrolled program gets long; the library factorization
# takes over.
UNROLL_MAX_N = 24


def _chol_unrolled(A):
    """Lower Cholesky factor as an n x n list of (B,) tensors, by the
    unrolled Crout recurrence."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    return L


def _solve_unrolled(L, b):
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def _library_spd_solve(A, b):
    """n > 24: batched library Cholesky with the NaN-as-failure contract."""
    n = A.shape[-1]
    L, info = torch.linalg.cholesky_ex(A)
    fail = (info > 0) | ~torch.isfinite(torch.diagonal(L, dim1=-2, dim2=-1)).all(-1)
    # Failed lanes solve against the identity so nothing non-finite is
    # produced; their steps are zero-filled below.
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    L = torch.where(fail[:, None, None], eye, L)
    x = torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)
    return torch.where(fail[:, None], torch.zeros_like(x), x), fail


def spd_solve(A: torch.Tensor, b: torch.Tensor):
    """Solve ``A x = b`` per lane for SPD ``A`` (B, n, n), ``b`` (B, n).

    Returns ``(x (B, n), fail (B,) bool)``: ``fail`` marks lanes whose
    factorization met a NaN (numerically non-SPD); their ``x`` is zero."""
    B, n = b.shape
    if n == 0:
        return torch.zeros_like(b), torch.zeros((B,), dtype=torch.bool, device=b.device)
    if n > UNROLL_MAX_N:
        return _library_spd_solve(A, b)
    L = _chol_unrolled(A)
    fail = torch.isnan(L[0][0])
    for i in range(1, n):
        fail = fail | torch.isnan(L[i][i])
    # Sanitize the factor so the solve never divides by NaN or 0 when the
    # result is discarded anyway.
    Lsafe = [row[:] for row in L]
    for i in range(n):
        Lsafe[i][i] = torch.where(torch.isnan(L[i][i]) | (L[i][i] == 0.0), 1.0, L[i][i])
        for k in range(i):
            Lsafe[i][k] = torch.where(torch.isnan(L[i][k]), 0.0, L[i][k])
    x = _solve_unrolled(Lsafe, b)
    return torch.where(fail[:, None], torch.zeros_like(x), x), fail

