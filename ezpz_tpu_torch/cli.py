"""Command-line interface of the PyTorch port.

The counterpart of ``ezpz_tpu.cli``, which mirrors the reference CLI
(``ezpz-cli/src/main.rs``):

    python -m ezpz_tpu_torch.cli -f problem.md [--image-path out.png] [--show-points]

Parses a problem file (or stdin with ``-f -``), solves it on the card
(``--cpu`` solves on the CPU), prints problem size / iterations / priority
/ warnings / unsatisfied constraints, times 100 re-solves and prints the
mean microseconds + solves/sec (red when below 60), and optionally renders
a PNG. Off the CPU it also prints the pipelined protocol's time (one
synchronization at the end). ``--profile DIR`` writes a ``torch.profiler``
Chrome trace of the timing loop into DIR.
"""

from __future__ import annotations

import argparse
import os
import sys

NUM_ITERS_BENCHMARK = 100
RED = "\x1b[31m"
YELLOW = "\x1b[33m"
RESET = "\x1b[0m"


def _color(text: str, code: str) -> str:
    if sys.stdout.isatty():
        return f"{code}{text}{RESET}"
    return text


def _print_warnings(warnings) -> None:
    if warnings:
        print("Warnings:")
        for w in warnings:
            print("\t" + _color(str(w), YELLOW))


def _print_unsatisfied(unsatisfied, constraints) -> None:
    if unsatisfied:
        print(_color("Not all constraints were satisfied:", RED))
        for idx in unsatisfied:
            print(f"\t{idx}: {constraints[idx].constraint.kind}")


def _print_problem_size(num_vars: int, num_eqs: int) -> None:
    line = f"{num_eqs} rows, {num_vars} vars"
    if num_vars != num_eqs:
        line = _color(line, YELLOW)
    print(f"Problem size: {line}")


def _print_performance(duration_s: float, pipelined_s=None) -> None:
    micros = int(duration_s * 1e6)
    print(f"Solved in {micros}μs (mean over {NUM_ITERS_BENCHMARK} iterations)")
    solves_per_second = int(1e6 / max(micros, 1))
    text = str(solves_per_second)
    if solves_per_second <= 60:
        text = _color(text, RED)
    print(f"i.e. {text} solves per second")
    if pipelined_s is not None:
        p_us = int(pipelined_s * 1e6)
        print(f"Pipelined (streamed dispatch, one sync): {p_us}μs/solve, "
              f"{int(1e6 / max(p_us, 1))} solves per second")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="ezpz-torch", description="2D constraint solver on an NVIDIA GPU (PyTorch)")
    parser.add_argument("-f", "--filepath", required=True,
                        help="Path to the problem file; '-' for stdin")
    parser.add_argument("-o", "--image-path", dest="image_path", default=None,
                        help="Save results as a PNG if solve was successful")
    parser.add_argument("--show-points", action="store_true",
                        help="Show the final values assigned to each point")
    parser.add_argument("--cpu", action="store_true",
                        help="Solve on the CPU instead of the GPU")
    parser.add_argument("--precision", choices=["f64", "mixed"], default="f64",
                        help="mixed = f32 LM + f64-residual refinement (same "
                             "1e-8 f64 verification; iteration counts not "
                             "comparable to the reference)")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="Write a torch.profiler Chrome trace of the "
                             "benchmark loop into DIR")
    args = parser.parse_args(argv)

    from .config import Config
    from .outcomes import FailureOutcome
    from .solver import resolve_device
    from .textual import Problem

    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    if args.filepath == "-":
        txt = sys.stdin.read()
    else:
        try:
            with open(args.filepath) as fh:
                txt = fh.read()
        except OSError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1

    try:
        parsed = Problem.from_str(txt)
        constraint_system = parsed.to_constraint_system()
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    config = Config().with_precision(args.precision)
    try:
        solved = constraint_system.solve_with_config(config, device=device)
    except FailureOutcome as outcome:
        _print_warnings(outcome.warnings)
        _print_problem_size(outcome.num_vars, outcome.num_eqs)
        print(
            _color("Could not solve system", RED) + f": {outcome.error}",
            file=sys.stderr,
        )
        if outcome.num_eqs > outcome.num_vars:
            print("Your system might be overconstrained. Try removing constraints.",
                  file=sys.stderr)
        else:
            print("You might have contradictory constraints.", file=sys.stderr)
        return 1

    # Benchmark: re-solve NUM_ITERS_BENCHMARK times (main.rs:96-100).
    profiler = None
    if args.profile:
        import torch.profiler as tp

        activities = [tp.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(tp.ProfilerActivity.CUDA)
        profiler = tp.profile(activities=activities)
        profiler.start()
    duration_per_iter = constraint_system.time_resolves(
        config, iters=NUM_ITERS_BENCHMARK, device=device)
    pipelined_per_iter = None
    if device.type != "cpu":
        pipelined_per_iter = constraint_system.time_resolves(
            config, iters=NUM_ITERS_BENCHMARK, pipelined=True, device=device)
    if profiler is not None:
        profiler.stop()
        os.makedirs(args.profile, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        print(f"Profiler trace written to {args.profile}/")

    _print_warnings(solved.warnings)
    _print_unsatisfied(solved.unsatisfied, constraint_system.constraints)
    _print_problem_size(solved.num_vars, solved.num_eqs)
    print(f"Iterations needed: {solved.iterations}")
    print(f"Solved up to priority: {solved.priority_solved}")
    if not solved.converged:
        print(_color("Error", RED) + ": solver did not converge!")
    _print_performance(duration_per_iter, pipelined_per_iter)

    if args.show_points:
        print("Points:")
        for label, p in solved.points.items():
            print(f"\t{label}: ({p.x:.2f}, {p.y:.2f})")
        if solved.circles:
            print("Circles:")
            for label, c in solved.circles.items():
                print(f"\t{label}: center = ({c.center.x:.2f}, {c.center.y:.2f}), "
                      f"radius = {c.radius:.2f}")
        if solved.arcs:
            print("Arcs:")
            for label, a in solved.arcs.items():
                print(f"\t{label}: center = ({a.center.x:.2f}, {a.center.y:.2f}), "
                      f"a = ({a.a.x:.2f}, {a.a.y:.2f}), b = ({a.b.x:.2f}, {a.b.y:.2f})")

    if args.image_path:
        from .viz import save_png

        chart_name = "EZPZ" if args.filepath == "-" else args.filepath
        save_png(solved, args.image_path, chart_name)

    return 0


if __name__ == "__main__":
    sys.exit(main())
