"""``h2d_copies_per_batch``: the program's host-to-device copies a batch,
its counter ``h2d.copies`` read at the traced window's edges. None where
the counter did not move or nothing ran on the device.
"""

from portbench import spans


def read(summary):
    return spans.reading(summary, "h2d_copies_per_batch")
