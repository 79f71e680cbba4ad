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


def rect_chain(R: int) -> Tuple[List[Constraint], np.ndarray]:
    """R rectangles chained corner to corner (``benches/midsize_bench.py``,
    the reference's ``two_rectangles_dependent`` generalised): 6R + 2
    constraints, 2 (3R + 1) variables, an RCM band 7 wide. Returns
    (constraints, initial guesses)."""
    pts = [DatumPoint(2 * i, 2 * i + 1) for i in range(3 * R + 1)]
    cons = [Constraint.Fixed(pts[0].x_id, 1.0), Constraint.Fixed(pts[0].y_id, 1.0)]
    guess = [(1.0, 1.0)]
    for k in range(R):
        s, u, v, w = pts[3 * k:3 * k + 4]
        cons += [
            Constraint.Horizontal(DatumLineSegment(s, u)),
            Constraint.Vertical(DatumLineSegment(u, v)),
            Constraint.Horizontal(DatumLineSegment(v, w)),
            Constraint.Vertical(DatumLineSegment(w, s)),
            Constraint.Distance(s, u, 4.0),
            Constraint.Distance(s, w, 3.0),
        ]
        sx, sy = guess[3 * k]
        guess += [(sx + 3.5, sy + 0.5), (sx + 4.2, sy + 3.4), (sx + 0.5, sy + 2.6)]
    return cons, np.array([c for p in guess for c in p])


def rect_grid(RX: int, RY: int) -> Tuple[List[Constraint], np.ndarray]:
    """An RX x RY grid of unit cells pinned at one corner
    (``benches/midsize_bench.py``): every horizontal edge Horizontal +
    Distance 1, every vertical edge Vertical + Distance 1; 2 (RX + 1)
    (RY + 1) variables, an RCM band about 2 min(RX, RY) + 3 wide. Guesses
    are the grid moved by seeded N(0, 0.05)."""
    P = [[DatumPoint(2 * (i * (RY + 1) + j), 2 * (i * (RY + 1) + j) + 1)
          for j in range(RY + 1)] for i in range(RX + 1)]
    cons = [Constraint.Fixed(P[0][0].x_id, 0.0), Constraint.Fixed(P[0][0].y_id, 0.0)]
    rng = np.random.default_rng(3)
    x0 = np.zeros(2 * (RX + 1) * (RY + 1))
    for i in range(RX + 1):
        for j in range(RY + 1):
            x0[P[i][j].x_id] = i + rng.normal(0, 0.05)
            x0[P[i][j].y_id] = j + rng.normal(0, 0.05)
            if i < RX:
                cons.append(Constraint.Horizontal(DatumLineSegment(P[i][j], P[i + 1][j])))
                cons.append(Constraint.Distance(P[i][j], P[i + 1][j], 1.0))
            if j < RY:
                cons.append(Constraint.Vertical(DatumLineSegment(P[i][j], P[i][j + 1])))
                cons.append(Constraint.Distance(P[i][j], P[i][j + 1], 1.0))
    return cons, x0


def every_kind(per_kind: int = 3, n_vars: int = 24, seed: int = 0, kinds=None):
    """A compiled system (float64) holding ``per_kind`` instances of each
    of the 23 residual kinds (or of ``kinds``, names of
    ``ops.kernels.KERNELS``), one constraint an instance, over ``n_vars``
    variables: seeded variable ids (the first instance of a kind of two or
    more variables names one variable twice), parameters as each kind
    takes them (a side sign, an interior flag, a sine and cosine pair,
    else lengths in [0.5, 20]) and weights in [0.5, 2]. Lowering does not
    build it: it exercises the evaluators, not a sketch."""
    from .models.compiled import CompiledSystem, KindBlock
    from .ops.kernels import KERNELS

    rng = np.random.default_rng(seed)
    blocks, cid, n_rows = [], 0, 0
    for name in sorted(KERNELS if kinds is None else kinds):
        spec = KERNELS[name]
        idx = np.stack([rng.choice(n_vars, spec.nvars, replace=False)
                        for _ in range(per_kind)]).astype(np.int32)
        if spec.nvars > 1:
            idx[0, 1] = idx[0, 0]
        par = rng.uniform(0.5, 20.0, (per_kind, spec.nparams))
        if name in ("lines_at_angle", "points_at_angle"):
            th = rng.uniform(-np.pi, np.pi, per_kind)
            par = np.stack([np.sin(th), np.cos(th)], axis=1)
        elif name == "line_tangent_circle":
            par = np.where(rng.random((per_kind, 1)) < 0.5, -1.0, 1.0)
        elif name == "circle_tangent_circle":
            par = np.where(rng.random((per_kind, 1)) < 0.5, 0.0, 1.0)
        blocks.append(KindBlock(spec=spec, idx=idx, par=par,
                                weight=rng.uniform(0.5, 2.0, per_kind),
                                cid=np.arange(cid, cid + per_kind, dtype=np.int32)))
        cid += per_kind
        n_rows += per_kind * spec.dim
    return CompiledSystem(n_vars=n_vars, n_constraints=cid, n_rows=n_rows,
                          blocks=tuple(blocks))
