"""Batched SPD solves for the LM loop.

The PyTorch counterpart of ``ezpz_tpu/ops/linalg.py``'s ``spd_solve`` and
``spd_solve_multi``. Every function works over explicit leading batch axes:
``A`` is ``(..., n, n)``, ``b`` is ``(..., n)`` (one right-hand side) or
``B`` is ``(..., n, r)`` (``r`` of them).

* n <= 24: the fully unrolled Cholesky-Crout over ``(...)`` columns, in the
  JAX package's operation order (``_chol_unrolled``, ``_solve_unrolled``)
  with its NaN/zero-diagonal sanitising; with several right-hand sides each
  factor entry broadcasts over the ``r`` columns;
* n > 24: ``torch.linalg.cholesky_ex`` and ``torch.cholesky_solve``. A lane
  fails on ``info > 0`` or on a non-finite diagonal of the factor
  (``cholesky_ex`` does not always report NaN input through ``info``).

Failure semantics are the JAX package's everywhere: a numerically non-SPD
lane reports ``fail`` and a zero-filled, finite ``x``; the LM loop treats it
as a rejected step.

The JAX package's TPU size tiers are not ported: the column sweep
(``_midsize_spd_solve``) and the blocked factorization exist because XLA's
batched Cholesky is slow on a TPU, so its heavily-batched entry points
``spd_solve_batched`` and ``spd_solve_multi_batched`` route here exactly as
``spd_solve`` and ``spd_solve_multi`` do. The banded factorization
(``ops/banded.py``) is ported for the partitioned-Schur boundary
(``parallel/block_schur.py``); ``BatchSolver``'s per-topology routing to
it (``batch._pick_spd``) is not.
"""

from __future__ import annotations

import torch

# Above this size the unrolled program gets long; the library factorization
# takes over.
UNROLL_MAX_N = 24


def _chol_unrolled(A):
    """Lower Cholesky factor as an n x n list of (...) tensors, by the
    unrolled Crout recurrence."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    return L


def _solve_unrolled(L, b):
    """Both substitutions on ``b`` (..., n); the factor's (...) entries
    broadcast over any further leading axes of ``b``."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
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


def _library_spd_solve(A, B):
    """n > 24: batched library Cholesky with the NaN-as-failure contract,
    on ``B`` (..., n, r)."""
    n = A.shape[-1]
    L, info = torch.linalg.cholesky_ex(A)
    fail = (info > 0) | ~torch.isfinite(torch.diagonal(L, dim1=-2, dim2=-1)).all(-1)
    # Failed lanes solve against the identity so nothing non-finite is
    # produced; their steps are zero-filled below.
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    L = torch.where(fail[..., None, None], eye, L)
    x = torch.cholesky_solve(B, L)
    return torch.where(fail[..., None, None], torch.zeros_like(x), x), fail


def _unrolled_factor(A):
    """The unrolled factor of ``A`` (..., n, n), sanitised so that the
    substitutions never divide by NaN or 0 when the result is discarded
    anyway, and the lanes whose factorization met a NaN."""
    n = A.shape[-1]
    L = _chol_unrolled(A)
    fail = torch.isnan(L[0][0])
    for i in range(1, n):
        fail = fail | torch.isnan(L[i][i])
    Lsafe = [row[:] for row in L]
    for i in range(n):
        Lsafe[i][i] = torch.where(torch.isnan(L[i][i]) | (L[i][i] == 0.0), 1.0, L[i][i])
        for k in range(i):
            Lsafe[i][k] = torch.where(torch.isnan(L[i][k]), 0.0, L[i][k])
    return Lsafe, fail


def spd_solve(A: torch.Tensor, b: torch.Tensor):
    """Solve ``A x = b`` per lane for SPD ``A`` (..., n, n), ``b`` (..., n).

    Returns ``(x (..., n), fail (...) bool)``: ``fail`` marks lanes whose
    factorization met a NaN (numerically non-SPD); their ``x`` is zero."""
    n = b.shape[-1]
    if n == 0:
        return torch.zeros_like(b), torch.zeros(b.shape[:-1], dtype=torch.bool,
                                                device=b.device)
    if n > UNROLL_MAX_N:
        x, fail = _library_spd_solve(A, b.unsqueeze(-1))
        return x.squeeze(-1), fail
    L, fail = _unrolled_factor(A)
    x = _solve_unrolled(L, b)
    return torch.where(fail[..., None], torch.zeros_like(x), x), fail


def spd_solve_multi(A: torch.Tensor, B: torch.Tensor):
    """Solve ``A X = B`` per lane for SPD ``A`` (..., n, n) and ``r``
    right-hand sides ``B`` (..., n, r): one factorization, then the
    substitutions of every column. Returns ``(X (..., n, r), fail (...))``
    with the same failure contract as ``spd_solve``."""
    n = A.shape[-1]
    if n == 0:
        return torch.zeros_like(B), torch.zeros(A.shape[:-2], dtype=torch.bool,
                                                device=B.device)
    if n > UNROLL_MAX_N:
        return _library_spd_solve(A, B)
    L, fail = _unrolled_factor(A)
    # Columns first, so that each (...) factor entry broadcasts over them.
    x = _solve_unrolled(L, B.movedim(-1, 0)).movedim(0, -1)
    return torch.where(fail[..., None, None], torch.zeros_like(x), x), fail


# The JAX package's entry points for callers that batch many solves of one
# shape route through its TPU column-sweep tier for 24 < n <= 64; here they
# are ``spd_solve`` and ``spd_solve_multi`` for every n.
spd_solve_batched = spd_solve
spd_solve_multi_batched = spd_solve_multi
