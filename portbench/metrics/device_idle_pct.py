"""``device_idle_pct``: the share of the traced window in which no
kernel, copy or set ran on the device, in percent. None where nothing ran
there.
"""


def read(summary):
    if summary["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
