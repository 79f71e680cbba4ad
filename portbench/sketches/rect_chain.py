"""Upstream's ``two_rectangles_dependent`` generalised to a chain of R
rectangles, corner to corner, as ``ezpz_tpu_torch/fixtures.rect_chain``
builds it (copied here, so the yardstick does not move with the program).

Point 0 is pinned at ``origin``. Rectangle k has the corners ``s, u, v, w``
(points ``3k .. 3k + 3``; its ``w`` is the next one's ``s``): ``s-u`` and
``v-w`` horizontal, ``u-v`` and ``w-s`` vertical, ``|s - u| = width`` and
``|s - w| = height``. The guesses put ``u, v, w`` at ``s + (W - 0.5,
0.5)``, ``s + (W + 0.2, H + 0.4)`` and ``s + (0.5, H - 0.4)`` for a
rectangle of width W and height H, ``s`` at the previous ``w`` (the
fixture's (3.5, 0.5), (4.2, 3.4), (0.5, 2.6) at 4 x 3).

A lane variant (``vary``) scales each distance by its own seeded factor.
The guesses are built from the lane's own widths and heights, then move
by seeded N(0, sigma).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.lm import DISTANCE, FIXED, HORIZONTAL, VERTICAL, Sketch

# Offsets of u, v, w from s, as (a W + b, c H + d): the fixture's guesses.
_OFFSETS = (((1.0, -0.5), (0.0, 0.5)), ((1.0, 0.2), (1.0, 0.4)), ((0.0, 0.5), (1.0, -0.4)))


def _pt(i):
    return 2 * i, 2 * i + 1


def plain(cfg) -> Sketch:
    """Fixed x and y of point 0, then per rectangle horizontal(s, u),
    vertical(u, v), horizontal(v, w), vertical(w, s), distance(s, u,
    width), distance(s, w, height): the fixture's order."""
    R, W, H = cfg["rectangles"], cfg["width"], cfg["height"]
    ox, oy = cfg["origin"]
    kinds = [FIXED, FIXED]
    ids = [(0, 0, 0, 0), (1, 0, 0, 0)]
    params = [ox, oy]
    for k in range(R):
        s, u, v, w = (_pt(3 * k + j) for j in range(4))
        kinds += [HORIZONTAL, VERTICAL, HORIZONTAL, VERTICAL, DISTANCE, DISTANCE]
        ids += [s + u, u + v, v + w, w + s, s + u, s + w]
        params += [0.0, 0.0, 0.0, 0.0, W, H]
    widths = np.full(R, W)
    heights = np.full(R, H)
    return Sketch(kinds=np.asarray(kinds, dtype=np.int64), ids=np.asarray(ids, dtype=np.int64),
                  params=np.asarray(params, dtype=np.float64),
                  guess=_guesses(np, np.asarray([ox, oy]), widths[None], heights[None])[0])


def _guesses(xp, origin, widths, heights):
    """Guesses (lanes, 2 (3R + 1)) from widths and heights (lanes, R), in
    the array module ``xp`` (numpy or torch)."""
    lanes, R = widths.shape
    offs = []
    for (a, b), (c, d) in _OFFSETS:
        offs.append(xp.stack([a * widths + b, c * heights + d], -1))  # (lanes, R, 2)
    # s_k = origin + the sum of the earlier rectangles' w offsets.
    steps = xp.cumsum(offs[2], 1)
    s = xp.concatenate([xp.zeros_like(steps[:, :1]), steps[:, :-1]], 1) + origin
    corners = xp.stack([s + o for o in offs], 2)  # (lanes, R, 3, 2): u, v, w
    first = xp.zeros_like(steps[:, :1]) + origin  # (lanes, 1, 2)
    return xp.concatenate([first.reshape(lanes, 2), corners.reshape(lanes, 6 * R)], 1)


def port_requests(cfg, params=None):
    """The program's constraint requests, built as the fixture builds them;
    ``params`` (the plain sketch's order) replaces the published values."""
    from ezpz_tpu_torch.constraints import Constraint, ConstraintRequest
    from ezpz_tpu_torch.datatypes import DatumLineSegment, DatumPoint

    R = cfg["rectangles"]
    p = plain(cfg).params if params is None else params
    ox, oy = float(p[0]), float(p[1])
    pts = [DatumPoint(*_pt(i)) for i in range(3 * R + 1)]
    cons = [Constraint.Fixed(pts[0].x_id, ox), Constraint.Fixed(pts[0].y_id, oy)]
    for k in range(R):
        s, u, v, w = pts[3 * k:3 * k + 4]
        W, H = float(p[6 * k + 6]), float(p[6 * k + 7])
        cons += [
            Constraint.Horizontal(DatumLineSegment(s, u)),
            Constraint.Vertical(DatumLineSegment(u, v)),
            Constraint.Horizontal(DatumLineSegment(v, w)),
            Constraint.Vertical(DatumLineSegment(w, s)),
            Constraint.Distance(s, u, W),
            Constraint.Distance(s, w, H),
        ]
    return [ConstraintRequest.highest_priority(c) for c in cons]


def lanes(cfg, sketch: Sketch, count: int, vary: bool, gen: torch.Generator, device):
    """``count`` lanes' (params (count, m), guesses (count, n)), float64 on
    ``device``, drawn from ``gen``."""
    R = cfg["rectangles"]
    params = torch.as_tensor(sketch.params, device=device).repeat(count, 1)
    factors = 1.0
    if vary:
        lo, hi = cfg["variants"]["distance_scale"]
        factors = lo + (hi - lo) * torch.rand((count, 2 * R), generator=gen,
                                              dtype=torch.float64, device=device)
    dist = torch.as_tensor(np.nonzero(sketch.kinds == DISTANCE)[0], device=device)
    params[:, dist] = params[:, dist] * factors
    widths = params[:, 6::6]
    heights = params[:, 7::6]
    origin = torch.as_tensor(cfg["origin"], dtype=torch.float64, device=device)
    guesses = _guesses(torch, origin, widths, heights)
    noise = torch.randn(guesses.shape, generator=gen, dtype=torch.float64, device=device)
    return params, guesses + cfg["variants"]["guess_sigma"] * noise
