"""PNG rendering of solved sketches (matplotlib).

Mirrors the reference CLI's plotters renderer (``ezpz-cli/src/visualize.rs``):
labeled points, lines, circles, CCW arcs sampled every 2 degrees
(``visualize.rs:304-317``), square bounds with a margin. A copy of
``ezpz_tpu.viz``; matplotlib is imported only when a PNG is drawn.
"""

from __future__ import annotations

import math
from typing import Optional

from .textual.executor import Outcome

POINT_COLOR = "#58508d"
LINE_COLOR = "#ffa600"
ARC_COLOR = "#ff6361"
CIRCLE_COLOR = "#bc5090"


def save_png(outcome: Outcome, output_path: str, chart_name: str = "EZPZ") -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8), dpi=200)

    xs, ys = [], []

    def track(x, y):
        xs.append(x)
        ys.append(y)

    for label, p in outcome.points.items():
        ax.plot([p.x], [p.y], "o", color=POINT_COLOR, markersize=6)
        ax.annotate(label, (p.x, p.y), textcoords="offset points", xytext=(6, 6),
                    color=POINT_COLOR, fontsize=12)
        track(p.x, p.y)

    for l0, l1 in outcome.lines:
        p0 = outcome.get_point(l0)
        p1 = outcome.get_point(l1)
        if p0 is None or p1 is None:
            continue
        ax.plot([p0.x, p1.x], [p0.y, p1.y], "-", color=LINE_COLOR, linewidth=2)

    for label, c in outcome.circles.items():
        theta = [math.radians(t) for t in range(0, 362, 2)]
        ax.plot(
            [c.center.x + c.radius * math.cos(t) for t in theta],
            [c.center.y + c.radius * math.sin(t) for t in theta],
            "-", color=CIRCLE_COLOR, linewidth=2,
        )
        ax.annotate(label, (c.center.x, c.center.y), color=CIRCLE_COLOR, fontsize=12)
        track(c.center.x - c.radius, c.center.y - c.radius)
        track(c.center.x + c.radius, c.center.y + c.radius)

    for label, a in outcome.arcs.items():
        r = math.hypot(a.a.x - a.center.x, a.a.y - a.center.y)
        t0 = math.atan2(a.a.y - a.center.y, a.a.x - a.center.x)
        t1 = math.atan2(a.b.y - a.center.y, a.b.x - a.center.x)
        # CCW sweep from a to b, sampled every 2 degrees (visualize.rs:304-317).
        sweep = (t1 - t0) % (2 * math.pi)
        n = max(2, int(math.degrees(sweep) / 2) + 1)
        ts = [t0 + sweep * i / (n - 1) for i in range(n)]
        ax.plot(
            [a.center.x + r * math.cos(t) for t in ts],
            [a.center.y + r * math.sin(t) for t in ts],
            "-", color=ARC_COLOR, linewidth=2,
        )
        track(a.center.x - r, a.center.y - r)
        track(a.center.x + r, a.center.y + r)

    if xs:
        lo = min(min(xs), min(ys))
        hi = max(max(xs), max(ys))
        pad = 0.1 * max(hi - lo, 1.0)
        ax.set_xlim(lo - pad, hi + pad)
        ax.set_ylim(lo - pad, hi + pad)
    ax.set_aspect("equal")
    ax.grid(True, alpha=0.3)
    ax.axhline(0, color="black", linewidth=0.8)
    ax.axvline(0, color="black", linewidth=0.8)
    ax.set_title(chart_name)
    fig.savefig(output_path, bbox_inches="tight")
    import matplotlib.pyplot as plt  # noqa: F811

    plt.close(fig)
    print(f"Plot saved to {output_path}")
