"""``launches_per_batch``: kernel launches a batch on the device (the
batched LM loop's eager launches, the benchmark's own solved count
included). None where no kernel ran.
"""


def read(summary):
    if summary["kernels"] == 0:
        return None
    return summary["kernels"] / summary["iterations"]
