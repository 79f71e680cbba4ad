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


def generate_coupled_hub(total_lines: int, cluster: int = 10) -> str:
    """The hub-coupled assembly of ``tools/gen_massive.py`` (problem text):
    line 0 is a pinned-length hub; the other lines form clusters of
    ``cluster`` lines chained by ``lines_equal_length``, each cluster's
    first line coupled to the hub. Its Schur complement over the coupling
    boundary is an arrow system of bounded condition at any size."""
    out = ["# constraints"]
    for line in range(total_lines):
        a, b = line * 2, line * 2 + 1
        out.append(f"point p{a}")
        out.append(f"point p{b}")
        out.append(f"vertical(p{a}, p{b})")
        out.append(f"p{a}.x={line}")
        out.append(f"p{a}.y=0")
    out.append("p1.y=4")  # hub length pinned; everything chains off it
    for line in range(1, total_lines):
        a, b = line * 2, line * 2 + 1
        k = (line - 1) % cluster  # position within the cluster
        if k == 0:
            pa, pb = 0, 1  # cluster head couples to the hub
        else:
            pa, pb = (line - 1) * 2, (line - 1) * 2 + 1
        out.append(f"lines_equal_length(p{pa}, p{pb}, p{a}, p{b})")
    out.append("")
    out.append("# guesses")
    for line in range(total_lines):
        a, b = line * 2, line * 2 + 1
        out.append(f"p{a} roughly ({line},0.1)")
        out.append(f"p{b} roughly ({line},3.5)")
    return "\n".join(out) + "\n"


def coupled_hub(total_lines: int, cluster: int = 10
                ) -> Tuple[List[Constraint], np.ndarray, np.ndarray]:
    """``generate_coupled_hub`` through the textual front end:
    ``(constraints, initial guesses, part_of_var)``, the parts the hub line
    (part 0) and one per cluster, so that only the hub and the cluster
    heads are boundary (4 + 4 * ceil((total_lines - 1) / cluster)
    variables)."""
    from .textual import Problem

    cs = Problem.from_str(generate_coupled_hub(total_lines, cluster)).to_constraint_system()
    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val
    line_of = np.arange(len(x0)) // 4
    part_of_var = np.where(line_of == 0, 0, 1 + (line_of - 1) // cluster)
    return [r.constraint for r in cs.constraints], x0, part_of_var
