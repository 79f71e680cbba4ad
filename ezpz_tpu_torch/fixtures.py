"""Shared example constraint systems.

The counterpart of ``ezpz_tpu/fixtures.py``: one function per demo
topology, so that what a bench measures and what a test pins is literally
the same system.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .constraints import Constraint
from .datatypes import DatumLineSegment, DatumPoint


def horizontal_chain(
    n_points: int,
    x_spacing: float = 1.05,
    x_offset: float = 0.1,
    y_offset: float = 0.05,
) -> Tuple[List[Constraint], np.ndarray]:
    """A coupled horizontal chain of unit links: NOT block-diagonal, so
    sharding it genuinely exercises cross-device boundary reduction.

    Point 0 is pinned at the origin; each consecutive pair is 1 apart and
    horizontal. Returns (constraints, initial_guesses): guesses are spaced
    ``x_spacing`` apart with the given offsets so the solve is nontrivial.
    """
    pts = [DatumPoint(2 * i, 2 * i + 1) for i in range(n_points)]
    constraints: List[Constraint] = [
        Constraint.Fixed(pts[0].x_id, 0.0),
        Constraint.Fixed(pts[0].y_id, 0.0),
    ]
    for i in range(n_points - 1):
        constraints.append(Constraint.Distance(pts[i], pts[i + 1], 1.0))
        constraints.append(
            Constraint.Horizontal(DatumLineSegment(pts[i], pts[i + 1]))
        )
    x0 = np.zeros(2 * n_points)
    x0[0::2] = np.arange(n_points) * x_spacing + x_offset
    x0[1::2] = y_offset
    return constraints, x0
