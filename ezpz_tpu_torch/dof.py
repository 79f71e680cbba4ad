"""Freedom (degrees-of-freedom) analysis.

The PyTorch counterpart of ``ezpz_tpu/dof.py``, which mirrors
``ezpz/src/solver/find_dof.rs``: an orthonormal basis of the Jacobian's
nullspace at the solved point, then each variable's "participation" (its
squared row norm in that basis). Row norms of an orthonormal nullspace
basis are basis-independent (the diagonal of the projector onto the
nullspace), so an SVD gives the reference's column-pivoted-QR values.

Two paths, as in the JAX package:

* ``freedom_analysis`` — host numpy, one system (the reference documents
  it as an expensive structure-change analysis, ``lib.rs:89-92``);
* ``participation_device`` / ``freedom_analysis_batch`` — one batched
  ``torch.linalg.svd`` on the tensor's device for a fleet of B Jacobians,
  one device-to-host copy, B host classifications. Nullspace rows are
  picked by masking the singular values against the same 1e-8 relative
  cut, so in exact arithmetic the values equal the host path's
  ``vt[rank:]`` slice.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .outcomes import FreedomAnalysis
from .solver import resolve_device
from .utils.errors import EmptySystemNotAllowed

TOLERANCE_BASE = 1e-8  # find_dof.rs:12


def freedom_analysis(jacobian: np.ndarray) -> FreedomAnalysis:
    """``jacobian``: dense (m, n) weighted Jacobian at the final values.

    A single row constraining only the first of three variables leaves the
    other two underconstrained:

    >>> freedom_analysis([[1.0, 0.0, 0.0]]).underconstrained()
    [1, 2]
    >>> freedom_analysis(np.eye(3)).is_underconstrained()
    False
    """
    j = np.asarray(jacobian, dtype=np.float64)
    m, nvars = j.shape
    if min(m, nvars) == 0:
        raise EmptySystemNotAllowed()

    # The reference thresholds |diag(R)| of a column-pivoted QR at
    # 1e-8 * max (find_dof.rs:40-47); singular values play the same role.
    _u, s, vt = np.linalg.svd(j, full_matrices=True)
    largest = float(s[0]) if s.size else 0.0
    tol = TOLERANCE_BASE * largest
    rank = int(np.sum(s > tol))
    if nvars - rank == 0:
        return FreedomAnalysis([])
    nullspace = vt[rank:, :].T  # (nvars, nullity), orthonormal columns
    return underconstrained_from_participation(np.sum(nullspace * nullspace, axis=1))


def participation_device(j: torch.Tensor):
    """Participation of dense Jacobians ``j`` (..., m, n) on their device:
    ``(participation (..., n), nullity (...) int32)``.

    With ``full_matrices=True`` the rows of ``vt`` past ``len(s)`` span the
    trailing nullspace (implicit zero singular values), so padding ``s``
    with zeros to n and masking ``s <= 1e-8 * s_max`` selects exactly the
    rows the host path slices with ``vt[rank:]``, for wide (m < n) and tall
    Jacobians alike."""
    n = j.shape[-1]
    _u, s, vt = torch.linalg.svd(j, full_matrices=True)
    k = s.shape[-1]
    if k < n:
        s = torch.cat([s, s.new_zeros(s.shape[:-1] + (n - k,))], dim=-1)
    tol = TOLERANCE_BASE * s[..., :1]
    mask = s <= tol  # (..., n): True rows of vt form the nullspace basis
    participation = torch.sum(vt * vt * mask[..., :, None].to(vt.dtype), dim=-2)
    return participation, mask.sum(dim=-1).to(torch.int32)


def underconstrained_from_participation(participation: np.ndarray) -> FreedomAnalysis:
    """Host classification step shared by both paths (find_dof.rs:81-104):
    a variable is underconstrained when its participation exceeds
    ``(1e-3 * max participation)^2``."""
    participation = np.asarray(participation)
    max_participation = float(participation.max()) if participation.size else 0.0
    var_tol = 1e-3 * max_participation
    squared_tol = var_tol * var_tol
    return FreedomAnalysis(
        [int(i) for i in np.nonzero(participation > squared_tol)[0]]
    )


def freedom_analysis_batch(j_batch, device=None) -> List[FreedomAnalysis]:
    """Batched analysis of (B, m, n) dense Jacobians on ``device`` (the
    card unless the caller names another): one batched SVD, one copy to
    the host, B host classifications. Loop-equivalent to
    ``freedom_analysis`` per item."""
    j_batch = torch.as_tensor(j_batch, dtype=torch.float64,
                              device=resolve_device(device))
    if j_batch.dim() != 3 or min(j_batch.shape[1:]) == 0:
        raise EmptySystemNotAllowed()
    parts, _null = participation_device(j_batch)
    parts = parts.cpu().numpy()
    return [underconstrained_from_participation(p) for p in parts]
