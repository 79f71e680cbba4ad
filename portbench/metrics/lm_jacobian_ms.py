"""``lm_jacobian_ms``: device milliseconds a batch in the kernels launched
under the program's ``ezpz.lm.jacobian`` span (the Jacobian passes of
``CompiledSystem.normal_equations``), charged by ``spans.summarize``'s
rule. None where the span did not open or nothing ran on the device.
"""

from portbench import spans


def read(summary):
    return spans.reading(summary, "lm_jacobian_ms")
