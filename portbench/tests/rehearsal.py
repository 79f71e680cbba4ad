"""The cells resized for a rehearsal on the CPU (the kernels' plain
versions), shared by the tests. Each cell's size is its own file,
``portbench/rehearsal/<cell>.json``: the overrides of its configuration
and traffic (``harness.Cell``)."""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness  # noqa: E402

CELLS = tuple(w["name"] for w in harness.benchmark()["workloads"])
SEED = 2**33 + 12345


# The check's faults, planted under a cell's timed call by its loop's
# ``plant(patch, change)``: ``change(x, x0)`` is what the call returns as
# its coordinates.
FAULTS = {
    # A step that returns its state unchanged: the guesses come back.
    "unchanged": lambda x, x0: torch.as_tensor(x0, dtype=x.dtype).clone(),
    # An answer altered where it is produced.
    "altered": lambda x, x0: x + 1e-6,
}


def overrides(name):
    """The cell's rehearsal file."""
    return harness.data("rehearsal", name)


def loop(name):
    """The cell's loop module, ``loops/<loop>.py``, by its traffic's
    ``loop``."""
    traffic = {**harness.data("traffic", harness.workload(name)["traffic"]),
               **overrides(name).get("traffic", {})}
    return harness.module("loops", traffic["loop"])


def cell(name, device="cpu"):
    """The rehearsal's ``harness.Cell``."""
    return harness.Cell(name, device, overrides(name))


def rehearse(name, traced=False, seconds=0.3, seed=SEED):
    """One rehearsal run on the CPU: (result, stderr lines)."""
    return harness.run_cell(name, seed, seconds, traced, device="cpu", overrides=overrides(name))
