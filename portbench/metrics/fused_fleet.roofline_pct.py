"""``fused_fleet.roofline_pct``: the fused fleet kernel's share of its
roofline (``ops/fused_fleet.py``, ``csrc/fused_fleet.cu``), in percent.

The least time of the traced batches' fleet solves (``roofline.
fleet_bound_s``: each lane's inputs read and answer written once, every
reported LM step's operations), over the device time of every launch of
the kernels named below. None where no such kernel ran.
"""

from portbench import roofline

KERNELS = ("fused_small_kernel", "fused_big_kernel")


def read(summary):
    seconds = sum(op["seconds"] for name, op in summary["device_ops"].items()
                  if any(k in name for k in KERNELS))
    buckets = summary["work"]["buckets"]
    if seconds <= 0 or not buckets:
        return None
    return 100.0 * roofline.fleet_bound_s(buckets, summary["iterations"]) / seconds
