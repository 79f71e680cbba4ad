"""``torch_ops_ms``: device milliseconds a batch in kernels that are
not the port's hand-written ones (PyTorch's own: the dense normal-equation
assembly, the damping copies, gathers and reductions of the batched LM
loop in ``solver.py`` and ``models/compiled.py``). None where no kernel
ran.
"""

HAND_WRITTEN = ("fused_small_kernel", "fused_big_kernel", "coarse_small_kernel",
                "coarse_big_kernel", "banded_spd_")


def read(summary):
    if summary["kernels"] == 0:
        return None
    seconds = sum(op["seconds"] for name, op in summary["device_ops"].items()
                  if op["cat"] == "kernel" and not any(k in name for k in HAND_WRITTEN))
    return 1e3 * seconds / summary["iterations"]
