#!/usr/bin/env python3
"""The readings a cell's limits are set from: the program's numbers over
many seeds (the lower readings) and the control's over a few (the upper),
in one process on the chip, at the cell's own size and load.

    python3 portbench/readings.py --workload chain64.fleet --seeds 12 --control 3 --seconds 2

Each seed makes the cell's input pool, runs a short window of the timed
path and compares the answers the check samples with the cell's
reference (``check.numbers``). On the first ``--control`` seeds, the
control then answers the same sampled cases: the reference, computed in
float32, in the program's place (``check.control_cases``). One JSON line
a reading, then the largest program reading and the smallest control
reading of each number. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from portbench import check, harness

    cell = harness.Cell(args.workload, args.device)
    program, control = [], []
    for j in range(args.seeds):
        seed = args.first_seed + 7919 * j
        rng = np.random.default_rng(seed)
        cell.loop.prepare(seed)
        cell.loop.run(seconds=args.seconds, keep=cell.loop.keep_for(rng))
        cases = cell.loop.answers(rng)
        found = check.numbers(cell.reference, cell.sketch, cases)
        program.append(found)
        print(json.dumps({"seed": seed, "side": "program", **found}), flush=True)
        if j < args.control:
            found = check.numbers(cell.reference, cell.sketch,
                                  check.control_cases(cell.reference, cell.sketch, cases))
            control.append(found)
            print(json.dumps({"seed": seed, "side": "control", **found}), flush=True)
    print(json.dumps({
        "workload": args.workload,
        "lower": {k: max(r[k] for r in program) for k in check.NAMES},
        "upper": {k: min(r[k] for r in control) for k in check.NAMES} if control else None,
        "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
