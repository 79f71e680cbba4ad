"""The cells resized for a rehearsal on the CPU (the kernels' plain
versions), shared by the tests."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness  # noqa: E402

SMALL = {
    "massive.fleet": {"config": {"total_lines": 30},
                      "traffic": {"systems_per_batch": 3, "pool": 2, "trace_iterations": 2}},
    "chain64.fleet": {"config": {"rectangles": 5},
                      "traffic": {"systems_per_batch": 3, "pool": 2, "trace_iterations": 2,
                                  "check_systems_per_batch": 3}},
}
CELLS = tuple(SMALL)
SEED = 2**33 + 12345


def cell(name, device="cpu"):
    """The rehearsal's ``harness.Cell``."""
    return harness.Cell(name, device, SMALL[name])


def rehearse(name, traced=False, seconds=0.3, seed=SEED):
    """One rehearsal run on the CPU: (result, stderr lines)."""
    return harness.run_cell(name, seed, seconds, traced, device="cpu", overrides=SMALL[name])
