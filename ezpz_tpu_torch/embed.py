"""Embedding smoke harness — the analog of the reference's WASM harness
(``ezpz-wasm/src/lib.rs:8-103``), as ``ezpz_tpu/embed.py`` has it.

The reference embeds the solver in a browser via wasm-bindgen and exposes
three sanity entry points (``hello``, ``test_faer``, ``benchmark``) that a
JS page calls and times. The port embeds in host applications as a plain
Python module (or over HTTP via ``ezpz_tpu_torch.serve``), so the harness
exposes the same three probes for any embedder to smoke-test the install:

* ``hello()``           — returns 33: the module loaded (``lib.rs:9-11``);
* ``test_linalg()``     — exercises the linear-algebra backend the way
  ``test_faer`` pokes faer (``lib.rs:14-25``): solves a known SPD system
  through the LM loop's own Cholesky routine, verifies the solution, and
  returns 1.0 (raises if the backend is broken);
* ``benchmark()``       — solves the exact two-dependent-rectangles system
  the wasm harness solves (``lib.rs:28-103``) and returns the final values
  as a plain list, for the embedder to time in a loop (``main.js:8-15``).

The two solving probes run on the card unless given ``device="cpu"``.
Run directly for a self-timed report (the ``main.js`` analog):

    python -m ezpz_tpu_torch.embed [--cpu]
"""

from __future__ import annotations

from typing import List


def hello() -> int:
    """Module-load probe (``ezpz-wasm/src/lib.rs:9-11``)."""
    return 33


def test_linalg(device=None) -> float:
    """Linear-algebra-backend probe (``ezpz-wasm/src/lib.rs:14-25``).

    The reference pokes faer; here the probe exercises the solver's SPD
    path on ``device`` (the card unless asked otherwise): build a known SPD
    system, solve it as a batch of one with ``ops.linalg.spd_solve`` (the
    routine the LM loop factorizes with), verify the solution, and return
    1.0 — so a broken Cholesky path fails here, not later inside
    production solves."""
    import torch

    from .ops.linalg import spd_solve
    from .solver import resolve_device

    dev = resolve_device(device)
    a = torch.tensor([[4.0, 1.0, 0.0], [1.0, 3.0, 1.0], [0.0, 1.0, 2.0]],
                     dtype=torch.float64, device=dev)
    x_true = torch.tensor([1.0, -2.0, 3.0], dtype=torch.float64, device=dev)
    x, fail = spd_solve(a[None], (a @ x_true)[None])
    if bool(fail[0]) or float((x[0] - x_true).abs().max()) > 1e-10:
        raise RuntimeError("SPD solve failed the embed probe")
    return 1.0


def benchmark(device=None) -> List[float]:
    """Solve the wasm harness's two-dependent-rectangles system
    (``ezpz-wasm/src/lib.rs:28-103``) on ``device`` (the card unless asked
    otherwise); returns the final variable values."""
    import ezpz_tpu_torch as ez

    ids = ez.IdGenerator()
    p0, p1, p2, p3 = (ez.DatumPoint.new(ids) for _ in range(4))
    p5, p6, p7 = (ez.DatumPoint.new(ids) for _ in range(3))

    constraints = [
        ez.Constraint.Fixed(p0.id_x(), 1.0),
        ez.Constraint.Fixed(p0.id_y(), 1.0),
        ez.Constraint.Horizontal(ez.DatumLineSegment(p0, p1)),
        ez.Constraint.Horizontal(ez.DatumLineSegment(p2, p3)),
        ez.Constraint.Vertical(ez.DatumLineSegment(p3, p0)),
        ez.Constraint.Vertical(ez.DatumLineSegment(p1, p2)),
        ez.Constraint.Distance(p0, p1, 4.0),
        ez.Constraint.Distance(p0, p3, 3.0),
        ez.Constraint.Horizontal(ez.DatumLineSegment(p2, p5)),
        ez.Constraint.Horizontal(ez.DatumLineSegment(p6, p7)),
        ez.Constraint.Vertical(ez.DatumLineSegment(p7, p2)),
        ez.Constraint.Vertical(ez.DatumLineSegment(p5, p6)),
        ez.Constraint.Distance(p2, p5, 4.0),
        ez.Constraint.Distance(p2, p7, 4.0),
    ]
    reqs = [ez.ConstraintRequest.highest_priority(c) for c in constraints]
    guesses = [
        (p0.id_x(), 1.0), (p0.id_y(), 1.0),
        (p1.id_x(), 4.5), (p1.id_y(), 1.5),
        (p2.id_x(), 4.0), (p2.id_y(), 3.5),
        (p3.id_x(), 1.5), (p3.id_y(), 3.0),
        (p5.id_x(), 5.5), (p5.id_y(), 3.5),
        (p6.id_x(), 5.0), (p6.id_y(), 4.5),
        (p7.id_x(), 2.5), (p7.id_y(), 4.0),
    ]
    out = ez.solve(reqs, guesses, ez.Config(), device=device)
    return [float(v) for v in out.final_values]


def _main(argv=None) -> int:
    """Self-timed report: the analog of the JS page timing 100 runs
    (``ezpz-wasm/main.js:1-16``)."""
    import argparse
    import time

    parser = argparse.ArgumentParser(prog="python -m ezpz_tpu_torch.embed")
    parser.add_argument("--cpu", action="store_true",
                        help="Run the probes on the CPU instead of the GPU")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else None

    assert hello() == 33
    assert test_linalg(device) == 1.0
    vals = benchmark(device)  # warmup (solver build)
    n = 100
    t0 = time.perf_counter()
    for _ in range(n):
        benchmark(device)
    dt = (time.perf_counter() - t0) / n
    where = "cpu" if args.cpu else "cuda"
    print(f"hello() = 33, test_linalg() = 1.0, benchmark(): {len(vals)} values")
    print(f"mean over {n} runs on {where}: {dt * 1e6:.0f}us ({1.0 / dt:.0f} solves/sec)")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
