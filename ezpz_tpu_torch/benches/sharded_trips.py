"""LM trips of the sharded two-level solver on the ``coupled`` chain.

Runs ``parallel.ShardedBlockSchurSolver`` as a world of one (no process
group) on the chain of ``coupled_bench.build_problem(lines)`` with one
boundary solver and precision, and prints one JSON line: the trips taken,
whether it converged under the given budget, max|r| after every trip, the
f64 residual recomputed at the answer, and host seconds. It is the witness
for how many trips a boundary solve's rounding costs: the same chain with
the banded boundary on the CPU (the plain version), or the dense or CG
boundary on the card, under the default budget.

    python -m ezpz_tpu_torch.benches.sharded_trips --cpu --boundary banded
    python -m ezpz_tpu_torch.benches.sharded_trips --boundary dense     # the card
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..config import Config
from ..models.compiled import compile_system
from ..parallel import ShardedBlockSchurSolver
from ..solver import resolve_device
from .coupled_bench import build_problem


def run(lines: int = 25_000, boundary: str = "banded", precision: str = "mixed",
        max_iterations: int = Config().max_iterations, device=None) -> dict:
    dev = resolve_device(device)
    cons, x0 = build_problem(lines)
    t0 = time.perf_counter()
    solver = ShardedBlockSchurSolver(cons, len(x0), boundary_solver=boundary,
                                     precision=precision, device=dev,
                                     config=Config(max_iterations=max_iterations))
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = solver.solve(x0)
    solve_s = time.perf_counter() - t0
    r = compile_system(cons, len(x0)).residual(torch.as_tensor(out["x"], device=dev)[None])
    return dict(lines=lines, n_vars=len(x0), boundary=boundary, precision=precision,
                device=str(dev), max_iterations=max_iterations,
                n_boundary=out["n_boundary"], iterations=out["iterations"],
                converged=bool(out["converged"]), f64_residual_max=float(r.abs().max()),
                history=solver.history, setup_s=setup_s, solve_s=solve_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lines", type=int, default=25_000)
    ap.add_argument("--boundary", choices=["dense", "cg", "banded"], default="banded")
    ap.add_argument("--precision", choices=["mixed", "f64"], default="mixed")
    ap.add_argument("--max-iterations", type=int, default=Config().max_iterations)
    ap.add_argument("--cpu", action="store_true", help="solve on the CPU")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.lines, args.boundary, args.precision, args.max_iterations,
                         "cpu" if args.cpu else None)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
