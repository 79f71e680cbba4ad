"""``band_solve.roofline_pct``: the banded factor-and-solve kernels' share
of their roofline (``ops/banded_spd.py``, ``csrc/banded_*.cu``), in
percent.

Each launch of a kernel named below factors and solves the lanes of the
one bucket past 24 variables (the band tier's), at its (lanes, n) and its
band under the benchmark's own ordering (``roofline.band_width``); its
least time (``roofline.band_bound_s``, float or double by the kernel's
name) summed over the launches, over their device time. A renamed or new
kernel is added to the list. None where no such kernel ran or the band's
bucket is not one.
"""

from portbench import roofline

KERNELS = ("banded_spd_lanes_kernel", "banded_spd_warp_kernel",
           "banded_spd_dynamic_kernel", "banded_spd_general_kernel")


def read(summary):
    banded = [b for b in summary["work"]["buckets"] if b["n"] > 24]
    if len(banded) != 1:
        return None
    b = banded[0]
    bound = seconds = 0.0
    for name, op in summary["device_ops"].items():
        if any(k in name for k in KERNELS):
            itemsize = 8 if "double" in name else 4
            bound += op["count"] * roofline.band_bound_s(b["lanes"], b["n"], b["bw"], itemsize)
            seconds += op["seconds"]
    return 100.0 * bound / seconds if seconds > 0 else None
