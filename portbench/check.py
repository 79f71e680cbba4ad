"""The comparison that decides ``correct``.

Each case is a sketch the timed path solved: the lane's parameters and
guesses, and the program's answer. The cell's reference, the module
``reference/<name>.py`` that its configuration names under
``"reference"``, solves the same case in float64 and judges the
program's answer by its own residuals. A reference module provides:

* ``solve(sketch, params, guess, dtype)``: the case solved from ``guess``
  with ``params``, every step in ``dtype``, as an ``Answer`` (``x``,
  ``converged``, ``satisfied`` and ``solved``, as ``reference/lm.py``'s);
* ``max_residual(sketch, params, x)``: the widest residual row of ``x``
  in float64, infinite if one is not finite;
* ``residual(kinds, ids, params, x)``: the residual rows, which the tests
  compare with the program's own rows.

It imports nothing of the program. The numbers, each with the limit of
the cell (``limits/<cell>.json``):

* ``resid``: the widest residual row, in float64, of the program's answer
  over the cases the program reports solved and the reference solves too
  (none such: infinite). The limit is the configuration's own residual
  tolerance.
* ``x_gap``: over the same cases, the widest gap between the program's and
  the reference's coordinates, relative to ``max(1, |x_ref|_inf)``.
* ``flags_off``: cases where the program's verdict (converged and every
  constraint satisfied) is not the reference's. Exact: limit 0.
"""

from __future__ import annotations

import numpy as np

NAMES = ("resid", "x_gap", "flags_off")


def numbers(reference, sketch, cases) -> dict:
    """The numbers over ``cases``, judged by the module ``reference`` in
    float64."""
    resid = x_gap = 0.0
    both = flags_off = 0
    for params, guess, answer in cases:
        ref = reference.solve(sketch, params, guess)
        flags_off += answer.solved != ref.solved
        if answer.solved and ref.solved:
            both += 1
            resid = max(resid, reference.max_residual(sketch, params, answer.x))
            scale = max(1.0, float(np.max(np.abs(ref.x))))
            gap = np.abs(answer.x - ref.x)
            x_gap = max(x_gap, float(gap.max()) / scale if np.isfinite(gap).all()
                        else float("inf"))
    if both == 0:
        resid = x_gap = float("inf")
    return {"resid": resid, "x_gap": x_gap, "flags_off": flags_off, "cases": len(cases)}


def control_cases(reference, sketch, cases, dtype=np.float32):
    """The control: the same cases with the module ``reference``, computed
    in ``dtype``, in the program's place."""
    return [(p, g, reference.solve(sketch, p, g, dtype=dtype)) for p, g, _answer in cases]


def verdict(found: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number within its
    limit (NaN is not)."""
    shown = {k: {"value": found[k], "limit": limits[k]} for k in NAMES}
    return all(found[k] <= limits[k] for k in NAMES), shown
