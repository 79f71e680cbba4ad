"""Upstream's ``massive_parallel_system``: independent vertical lines, each
with one end pinned at ``(line, 0)`` and the other end's height pinned.

``text`` is upstream's generator (``test_cases/massive_parallel_system/
gen_big_problem.py``, as ``tools/gen_massive.py`` repeats it), so the
program parses the published fixture; ``plain`` gives the same sketch as
the reference's plain data. Point ``p<k>`` has the variable ids ``(2k, 2k
+ 1)``, the ids the textual front end assigns in declaration order.

A lane variant (``vary``) scales the whole sketch by one seeded factor:
every pinned coordinate and the pinned height (so the answer scales with
it), and the guesses. The guesses then move by seeded N(0, sigma).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.lm import FIXED, VERTICAL, Sketch


def _num(v) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def text(cfg, params=None) -> str:
    """The problem text; ``params`` (the plain sketch's order) replaces the
    published values."""
    out = ["# constraints"]
    for line in range(cfg["total_lines"]):
        a, b = line * 2, line * 2 + 1
        x, y, h = ((line, 0, cfg["height"]) if params is None
                   else params[4 * line + 1:4 * line + 4])
        out.append(f"point p{a}")
        out.append(f"point p{b}")
        out.append(f"vertical(p{a}, p{b})")
        out.append(f"p{a}.x={_num(x)}")
        out.append(f"p{a}.y={_num(y)}")
        out.append(f"p{b}.y={_num(h)}")
    out.append("")
    out.append("# guesses")
    for line in range(cfg["total_lines"]):
        a, b = line * 2, line * 2 + 1
        out.append(f"p{a} roughly ({a},{a})")
        out.append(f"p{b} roughly ({b},{b})")
    return "\n".join(out) + "\n"


def plain(cfg) -> Sketch:
    """Per line: vertical(pa, pb), pa.x = line, pa.y = 0, pb.y = height,
    in the text's order."""
    kinds, ids, params = [], [], []
    for line in range(cfg["total_lines"]):
        a, b = 2 * line, 2 * line + 1
        ax, ay, bx, by = 2 * a, 2 * a + 1, 2 * b, 2 * b + 1
        kinds += [VERTICAL, FIXED, FIXED, FIXED]
        ids += [(ax, ay, bx, by), (ax, 0, 0, 0), (ay, 0, 0, 0), (by, 0, 0, 0)]
        params += [0.0, float(line), 0.0, float(cfg["height"])]
    n_points = 2 * cfg["total_lines"]
    guess = np.repeat(np.arange(n_points, dtype=np.float64), 2)
    return Sketch(kinds=np.asarray(kinds, dtype=np.int64),
                  ids=np.asarray(ids, dtype=np.int64),
                  params=np.asarray(params), guess=guess)


def port_requests(cfg, params=None):
    """The program's constraint requests, parsed from ``text``."""
    from ezpz_tpu_torch.textual import Problem

    system = Problem.from_str(text(cfg, params)).to_constraint_system()
    return list(system.constraints)


def lanes(cfg, sketch: Sketch, count: int, vary: bool, gen: torch.Generator, device):
    """``count`` lanes' (params (count, m), guesses (count, n)), float64 on
    ``device``, drawn from ``gen``."""
    base_p = torch.as_tensor(sketch.params, device=device)
    base_x = torch.as_tensor(sketch.guess, device=device)
    scale = torch.ones((count, 1), dtype=torch.float64, device=device)
    if vary:
        lo, hi = cfg["variants"]["scale"]
        scale = lo + (hi - lo) * torch.rand((count, 1), generator=gen, dtype=torch.float64,
                                            device=device)
    noise = torch.randn((count, base_x.shape[0]), generator=gen, dtype=torch.float64,
                        device=device)
    return base_p * scale, base_x * scale + cfg["variants"]["guess_sigma"] * noise
