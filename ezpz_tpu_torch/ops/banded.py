"""Banded SPD Cholesky factor and solve over a batch of lanes.

The PyTorch counterpart of ``ezpz_tpu/ops/banded.py``. A chain-like coupled
system's boundary Schur complement is (block-)tridiagonal under the natural
boundary ordering, so it is stored and factored as a band of half-bandwidth
``bw``: O(n * bw^2) work instead of the dense O(n^3) Cholesky.

Storage is the JAX package's LOWER band, with a leading batch axis:
``Ab[k, i, d] = A_k[i, i - bw + d]`` for ``d in [0, bw]`` (``Ab[k, i, bw]``
is the diagonal); entries that fall off the left edge are zero. The factor
uses the same layout. Rows above the top are virtual identity rows, so the
first real rows divide by 1.0 and subtract 0.0 for out-of-range terms.

``banded_spd_solve`` dispatches on the device: a CUDA band of any width
goes to the hand-written kernels (``ops/banded_spd.py``,
``csrc/banded_spd.cu``), which raise rather than fall back; a CPU band
takes the plain version here, ``banded_spd_reference``: the JAX package's
``lax.scan`` bodies written out as a loop over rows of (B,) tensor
operations, every sum taken in a fixed order, term by term, that the
kernels repeat (in eager PyTorch that loop is a chain of about
``n * (bw^2 + 3 bw)`` launches, which is why the card does not run it).

``plan_band`` and ``make_banded_spd`` are the per-topology band route of
``BatchSolver``'s normal equations (``batch._pick_spd``, as the JAX
package's): a topology of more than 24 variables whose identity or RCM
ordering has a narrow band solves its damped JtJ here on every LM trip.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from . import banded_spd
from .fleet_plan import _jtj_pattern, _rcm_order

# Bandwidth ceiling of ``plan_band`` (the JAX package's value), for its own
# routing only: ``banded_spd_solve`` takes any half-bandwidth on either
# device (on the card, ``ops.banded_spd.route_for`` picks the kernel).
BANDED_MAX_BW = 32


def banded_cholesky(Ab: torch.Tensor):
    """Factor SPD banded matrices given as lower bands ``Ab`` (B, n, bw+1).

    Returns ``(Lb, fail)``: ``Lb`` in the same layout (``Lb[:, i, bw]`` the
    diagonal of L) and ``fail`` (B,) bool, set when a pivot is non-finite or
    non-positive. A failed pivot is sanitised to 1.0, so the factor can be
    substituted with and the result discarded (``ops.linalg.spd_solve``'s
    contract)."""
    B, n, bwp1 = Ab.shape
    bw = bwp1 - 1
    zero = torch.zeros((B,), dtype=Ab.dtype, device=Ab.device)
    one = torch.ones_like(zero)
    # window[k][e]: band entry e of factor row i - bw + k (identity rows
    # above the top).
    window = [[zero] * bw + [one] for _ in range(bw)]
    fail = torch.zeros((B,), dtype=torch.bool, device=Ab.device)
    rows = []
    for i in range(n):
        a = Ab[:, i]
        row = [None] * bwp1
        for d in range(bw):
            # Row j = i - bw + d sits at window[d]; row i's column
            # i - bw + t sits at position t - d + bw of row j's band.
            s = zero
            for t in range(d):
                s = s + row[t] * window[d][t - d + bw]
            row[d] = (a[:, d] - s) / window[d][bw]
        s = zero
        for t in range(bw):
            s = s + row[t] * row[t]
        diag2 = a[:, bw] - s
        bad = ~(diag2 > 0) | ~torch.isfinite(diag2)
        row[bw] = torch.where(bad, one, torch.sqrt(torch.where(bad, one, diag2)))
        fail = fail | bad
        window = window[1:] + [row]
        rows.append(torch.stack(row, dim=-1))
    if not rows:
        return Ab.clone(), fail
    return torch.stack(rows, dim=1), fail


def banded_solve(Lb: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L L^T x = b`` given the lower-band factor ``Lb`` (B, n, bw+1)
    from ``banded_cholesky``; ``b`` is (B, n) or (B, n, m)."""
    B, n, bwp1 = Lb.shape
    bw = bwp1 - 1
    vec = b.dim() == 2
    r = b[..., None] if vec else b
    lcol = lambda i, d: Lb[:, i, d, None]  # noqa: E731  (broadcast over m)
    zero = torch.zeros((B, r.shape[-1]), dtype=Lb.dtype, device=Lb.device)
    # Forward: y[i] = (b[i] - sum_{d<bw} L[i, i-bw+d] y[i-bw+d]) / L[i, i].
    carry = [zero] * bw
    y = []
    for i in range(n):
        s = zero
        for d in range(bw):
            s = s + lcol(i, d) * carry[d]
        yi = (r[:, i] - s) / lcol(i, bw)
        carry = carry[1:] + [yi]
        y.append(yi)
    # Backward with L^T: x[i] = (y[i] - sum_{t=1..bw} L[i+t, i] x[i+t]) / L[i, i];
    # row i+t's entry for column i sits at band position bw - t. Rows
    # below the bottom are virtual identity rows (their terms are 0 * 0).
    x = [None] * n
    for i in reversed(range(n)):
        s = zero
        for t in range(1, bw + 1):
            if i + t < n:
                s = s + lcol(i + t, bw - t) * x[i + t]
        x[i] = (y[i] - s) / lcol(i, bw)
    if not x:
        return torch.zeros_like(b)
    out = torch.stack(x, dim=1)
    return out[..., 0] if vec else out


def banded_spd_reference(Ab: torch.Tensor, b: torch.Tensor):
    """The plain version of ``banded_spd_solve`` (any device): factor, both
    substitutions, ``x`` zero-filled on failed lanes."""
    Lb, fail = banded_cholesky(Ab)
    x = banded_solve(Lb, b)
    mask = fail.view((-1,) + (1,) * (x.dim() - 1))
    return torch.where(mask, torch.zeros_like(x), x), fail


def banded_spd_solve(Ab: torch.Tensor, b: torch.Tensor):
    """``spd_solve``'s contract for banded matrices: ``Ab`` (B, n, bw+1) and
    ``b`` (B, n) or (B, n, m) give ``(x, fail (B,))``, ``x`` zero-filled on
    failed lanes. A CUDA band launches a hand-written kernel or raises; a
    CPU band takes ``banded_spd_reference``."""
    if Ab.device.type == "cuda":
        return banded_spd.banded_spd_cuda(Ab, b)
    if Ab.device.type != "cpu":
        raise ValueError(f"unsupported device {Ab.device}")
    return banded_spd_reference(Ab, b)


def plan_band(system):
    """Bandwidth plan for a topology's damped normal equations: ``(perm,
    bw)`` for the narrowest half-bandwidth of the identity or RCM ordering
    of the JtJ graph (``perm`` None for the identity, else position k holds
    the variable eliminated k-th), or None when no ordering is narrow
    enough for the band to beat the dense factorization (the JAX package's
    rule: ``bw <= BANDED_MAX_BW`` and ``bw + 1 < n // 2``)."""
    n = system.n_vars
    ids_list = [
        (None, [int(j) for j in b.idx[i]])
        for b in system.blocks
        for i in range(b.idx.shape[0])
    ]
    if not ids_list or n == 0:
        return None
    pat = _jtj_pattern(ids_list, n)
    best_bw = max((i - j for (i, j) in pat))
    best_perm = None
    rcm = _rcm_order(pat, n)
    inv = [0] * n
    for k, v in enumerate(rcm):
        inv[v] = k
    bw_rcm = max((abs(inv[i] - inv[j]) for (i, j) in pat))
    if bw_rcm < best_bw:
        best_bw, best_perm = bw_rcm, rcm
    if best_bw > BANDED_MAX_BW or best_bw + 1 >= n // 2:
        return None
    return (None if best_perm is None else np.asarray(best_perm)), best_bw


def make_banded_spd(n: int, bw: int, perm=None):
    """An ``spd(A, b) -> (x, fail)`` with ``spd_solve``'s contract for dense
    ``A`` (B, n, n) whose entries outside the ``bw``-wide band of the
    ordering ``perm`` are exact zeros (``plan_band``): the lower band of the
    permuted matrix gathered straight from ``A`` (entry ``[i, i - bw + d]``
    of the permuted matrix is ``A[perm[i], perm[i - bw + d]]``; no permuted
    copy of ``A`` is made), ``banded_spd_solve`` on it and ``b[:, perm]``,
    then x gathered back through the inverse permutation. ``BatchSolver``
    calls it on every LM trip (``batch._pick_spd``): its index tensors are
    copied to a device once, at that device's first call (counted in
    ``tracing``'s ``h2d.copies``)."""
    p = np.arange(n) if perm is None else np.asarray(perm, dtype=np.int64)
    rows = np.arange(n)[:, None]
    cols = rows - bw + np.arange(bw + 1)[None, :]
    tables = (p[rows], p[np.clip(cols, 0, max(n - 1, 0))], cols >= 0,
              None if perm is None else p, None if perm is None else np.argsort(p))
    by_device = {}

    def spd(A, b):
        dev = A.device
        if dev not in by_device:
            by_device[dev] = tuple(None if t is None else torch.as_tensor(t, device=dev)
                                   for t in tables)
            tracing.count("h2d.copies", sum(t is not None for t in tables))
        r_idx, c_idx, inside, fwd, inv = by_device[dev]
        band = torch.where(inside, A[:, r_idx, c_idx],
                           torch.zeros((), dtype=A.dtype, device=dev))
        x_p, fail = banded_spd_solve(band, b if fwd is None else b[:, fwd])
        return (x_p, fail) if inv is None else (x_p[:, inv], fail)

    return spd


def dense_to_band(A: torch.Tensor, bw: int) -> torch.Tensor:
    """The lower band (B, n, bw+1) of dense matrices ``A`` (B, n, n)."""
    n = A.shape[-1]
    rows = torch.arange(n, device=A.device)[:, None]
    cols = rows - bw + torch.arange(bw + 1, device=A.device)[None, :]
    vals = A[:, rows, cols.clamp(0, max(n - 1, 0))]
    return torch.where(cols >= 0, vals, torch.zeros((), dtype=A.dtype, device=A.device))
