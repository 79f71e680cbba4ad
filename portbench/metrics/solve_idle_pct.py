"""``solve_idle_pct``: the share of the traced window in which the device
was idle while the host was inside the program's ``ezpz.batch.solve``
span (``BatchSolver.solve``), in percent. None where the span did not
open or nothing ran on the device.
"""

from portbench import spans


def read(summary):
    return spans.reading(summary, "solve_idle_pct")
