"""``lm_assembly_ms``: device milliseconds a batch in the kernels launched
under the program's ``ezpz.lm.assemble`` span (the JtJ and Jtr assembly,
dense or into the band), charged by ``spans.summarize``'s rule. None
where the span did not open or nothing ran on the device.
"""

from portbench import spans


def read(summary):
    return spans.reading(summary, "lm_assembly_ms")
