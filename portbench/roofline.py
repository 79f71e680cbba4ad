"""The yardstick of the roofline readers: the card's published peaks and
the least work a solve needs, counted from the sketch's own shapes.

Peaks: NVIDIA H100 SXM data sheet, at its full 700 W power limit (the run
prints the card's ``power.limit`` beside every share): HBM 3.35 TB/s,
67 TFLOP/s in float32 and 34 TFLOP/s in float64 outside the tensor cores.

A share is the least time (the larger of bytes over the memory rate and
operations over the arithmetic rate) over the kernel's device time, so it
cannot pass 100% unless the work is counted too high.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

from portbench.reference.lm import DISTANCE, FIXED, HORIZONTAL, VERTICAL

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12

# The slots of a constraint's ids that its residual reads (the reference's
# residuals): a fixed value one, horizontal the two y's, vertical the two
# x's, a distance both points.
_READS = {FIXED: [0], HORIZONTAL: [1, 3], VERTICAL: [0, 2], DISTANCE: [0, 1, 2, 3]}


def _reads(sketch, c):
    return [int(v) for v in sketch.ids[c, _READS[int(sketch.kinds[c])]]]


def component_shape(sketch, constraint_ids, var_ids) -> dict:
    """The shape of one independent part of the sketch (the constraints
    ``constraint_ids`` over the variables ``var_ids``): its variables,
    constraints (one residual row each for the kinds here), parameters,
    the variables each constraint reads, and the band of its variable
    graph under reverse Cuthill-McKee (or the identity, if narrower)."""
    reads = [len(_reads(sketch, c)) for c in constraint_ids]
    params = sum(int(sketch.kinds[c]) in (FIXED, DISTANCE) for c in constraint_ids)
    return dict(n=len(var_ids), m=len(constraint_ids), params=params, reads=reads,
                bw=band_width(sketch, constraint_ids, var_ids))


def band_width(sketch, constraint_ids, var_ids) -> int:
    """The band of the normal equations: the widest |i - j| over pairs of
    variables one constraint couples, in the better of the identity and
    the reverse Cuthill-McKee order."""
    local = {int(v): i for i, v in enumerate(var_ids)}
    pairs = []
    for c in constraint_ids:
        ids = [local[v] for v in _reads(sketch, c)]
        pairs += [(a, b) for a in ids for b in ids]
    n = len(var_ids)
    rows, cols = np.asarray(pairs).T
    graph = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    order = reverse_cuthill_mckee(graph, symmetric_mode=True)
    where = np.empty(n, dtype=np.int64)
    where[order] = np.arange(n)
    return int(min(np.abs(rows - cols).max(), np.abs(where[rows] - where[cols]).max()))


def step_ops(n: int, reads) -> int:
    """A lower bound of one LM step's operations for one lane: a Jacobian
    entry, its products into the JtJ lower triangle and into Jtr per row,
    a dense factorization of the n x n system, both substitutions and the
    update, and the trial residual (3 operations a row)."""
    jac = sum(v + 2 * v * (v + 1) // 2 + 2 * v for v in reads)
    factor = n * (n + 1) * (n + 2) // 3
    return jac + factor + 2 * n * n + 3 * n + 3 * len(reads)


def fleet_bound_s(buckets, batches: int) -> float:
    """The least time of the fleet kernel over ``batches`` batches of the
    buckets (``lanes`` a batch, ``steps`` over all the batches): each
    lane's guesses and parameters read once (float64) and its answer
    written once (x float64, iterations int32, converged, and satisfied and
    degenerate per constraint, a byte each), against every reported LM
    step's operations at the float32 rate."""
    nbytes = ops = 0
    for b in buckets:
        per_lane = 8 * b["n"] + 8 * b["params"] + 8 * b["n"] + 4 + 1 + 2 * b["m"]
        nbytes += batches * b["lanes"] * per_lane
        ops += b["steps"] * step_ops(b["n"], b["reads"])
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def band_bound_s(lanes: int, n: int, bw: int, itemsize: int) -> float:
    """The least time of one banded factor-and-solve of ``lanes`` lanes:
    the band, the right-hand side and x moved once (and a fail flag a
    lane), against the factor's and both substitutions' operations per row
    (bw^2 + 3 bw + 2, then 2 bw + 2 twice) at the float32 or float64 rate."""
    nbytes = lanes * n * (bw + 3) * itemsize + lanes
    ops = lanes * n * (bw * bw + 7 * bw + 6)
    rate = F32_OPS_PER_S if itemsize == 4 else F64_OPS_PER_S
    return max(nbytes / HBM_BYTES_PER_S, ops / rate)
