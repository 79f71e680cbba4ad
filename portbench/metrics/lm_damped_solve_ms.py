"""``lm_damped_solve_ms``: device milliseconds a batch in the kernels
launched under the program's ``ezpz.lm.damped_solve`` span (the damped
normal equations solved, dense or in the band), charged by
``spans.summarize``'s rule. None where the span did not open or nothing
ran on the device.
"""

from portbench import spans


def read(summary):
    return spans.reading(summary, "lm_damped_solve_ms")
