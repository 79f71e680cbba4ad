#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ezpz_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. the card (``nvidia-smi`` name and power limit) and the CUDA runtime;
   no GPU, no run;
2. build the fused fleet kernel (``csrc/fused_fleet.cu``) with nvcc;
3. kernel against its plain PyTorch version on the card, on every bucket
   of every corpus fixture plus ``rect_chain(8)``: 4096 seeded
   perturbations (sigma 1e-3) of the guesses each; converged, satisfied
   and degenerate must be equal lane for lane, iterations equal on at
   least 99.9% of lanes, coordinates within 1e-6 where both converged;
4. the main path of ``bench.py`` through the port: the
   ``massive_parallel_system`` fixture at 8192 copies (9.8 M one-variable
   and 4.9 M two-variable sketches) via ``Problem.from_str`` ->
   ``to_constraint_system`` -> ``build_buckets`` -> ``BatchSolver(...,
   precision="mixed", pallas_fused=True, pallas_trips=3,
   refine_trips=2).solve`` on CUDA tensors. Every lane converged and
   satisfied, the f64 residual recomputed by ``residual_and_flags`` <=
   1e-8, the kernel launched; then 5 timed reps with fresh inputs for the
   kernel and for the plain version.

The line before the last is a JSON record of the kernel (launches in the
main-path run, max |x_kernel - x_plain|, ms per main-path solve for the
kernel and for the plain version, CUDA events); the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
COPIES = 8192
REPS = 5
PHASE3_B = 4096
X_TOL = 1e-6
ITER_EQUAL_MIN = 0.999


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log_path):
    """One line per kernel instantiation from nvcc's -Xptxas -v log:
    registers, stack frame and spills."""
    import re

    if not os.path.exists(log_path):
        return []
    out, name = [], None
    for line in open(log_path):
        m = re.search(r"Compiling entry function '.*fused_fleet_kernelILi(\d+)ELi(\d+)E", line)
        if m:
            name = f"fused_fleet_kernel<{m.group(1)},{m.group(2)}>"
        elif name and "stack frame" in line:
            frame = line.strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {frame}")
            name = None
    return out


def guesses(cs):
    import numpy as np

    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val
    return x0


def rect_chain(R):
    """R rectangles chained corner to corner (benches/midsize_bench.py):
    6R+2 constraints, 2(3R+1) variables."""
    import numpy as np

    from ezpz_tpu_torch import Constraint, DatumLineSegment, DatumPoint, IdGenerator

    ids = IdGenerator()
    pts = [DatumPoint.new(ids) for _ in range(3 * R + 1)]
    cons = [Constraint.Fixed(pts[0].id_x(), 1.0), Constraint.Fixed(pts[0].id_y(), 1.0)]
    guess = [(1.0, 1.0)]
    for k in range(R):
        s, u, v, w = pts[3 * k:3 * k + 4]
        cons += [
            Constraint.Horizontal(DatumLineSegment(s, u)),
            Constraint.Vertical(DatumLineSegment(u, v)),
            Constraint.Horizontal(DatumLineSegment(v, w)),
            Constraint.Vertical(DatumLineSegment(w, s)),
            Constraint.Distance(s, u, 4.0),
            Constraint.Distance(s, w, 3.0),
        ]
        sx, sy = guess[3 * k]
        guess += [(sx + 3.5, sy + 0.5), (sx + 4.2, sy + 3.4), (sx + 0.5, sy + 2.6)]
    return cons, np.array([c for p in guess for c in p])


def topologies():
    """(label, constraints, x0) for every corpus fixture and rect_chain(8)."""
    from ezpz_tpu_torch.textual import Problem

    cases = os.path.join(HERE, "tests", "cases")
    for name in sorted(os.listdir(cases)):
        path = os.path.join(cases, name, "problem.md")
        if not os.path.exists(path):
            continue
        with open(path) as fh:
            cs = Problem.from_str(fh.read()).to_constraint_system()
        x0 = guesses(cs)
        yield name, [r.constraint.set_from_initial_values(x0) for r in cs.constraints], x0
    cons, x0 = rect_chain(8)
    yield "rect_chain(8)", cons, x0


def compare(out, ref):
    """Mismatch counts of kernel against plain results."""
    import torch

    x, it, conv, sat, deg = out
    rx, rit, rconv, rsat, rdeg = ref
    both = conv & rconv
    err = float((x - rx).abs()[both].max()) if bool(both.any()) else 0.0
    return dict(
        lanes=int(conv.numel()),
        conv_mismatch=int((conv != rconv).sum()),
        sat_mismatch=int((sat != rsat).any(dim=1).sum()),
        deg_mismatch=int((deg != rdeg).any(dim=1).sum()),
        iter_equal=float((it == rit).double().mean()),
        converged=float(conv.double().mean()),
        x_err=err,
        bit_equal_x=bool(torch.equal(x, rx)),
    )


def check(label, c):
    ok = (c["conv_mismatch"] == 0 and c["sat_mismatch"] == 0
          and c["deg_mismatch"] == 0 and c["iter_equal"] >= ITER_EQUAL_MIN
          and c["x_err"] <= X_TOL)
    print(f"phase3 {label}: " + json.dumps(c), flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: kernel disagrees with plain on {label}")


def phase3(dev):
    import numpy as np
    import torch

    from ezpz_tpu_torch.batch import BatchSolver
    from ezpz_tpu_torch.config import Config
    from ezpz_tpu_torch.models.blocks import build_buckets
    from ezpz_tpu_torch.ops import fused_fleet

    seed = 0
    n_topologies = 0
    for name, cons, x0 in topologies():
        for bi, b in enumerate(build_buckets(cons, len(x0))):
            solver = BatchSolver(b.system, Config(), batch_params=True,
                                 precision="mixed", pallas_fused=True,
                                 pallas_trips=3, refine_trips=2)
            rng = np.random.default_rng(seed)
            seed += 1
            k = np.arange(PHASE3_B) % len(b.components)
            xb = torch.as_tensor(
                x0[b.var_index[k]] + rng.normal(0, 1e-3, (PHASE3_B, b.system.n_vars)),
                device=dev)
            pars = tuple(torch.as_tensor(np.asarray(p)[k], device=dev) for p in b.pars)
            out = fused_fleet.fused_fleet_solve(solver.plan, xb, pars, **solver.settings())
            torch.cuda.synchronize()
            ref = fused_fleet.fused_fleet_reference(solver.plan, xb, pars,
                                                    **solver.settings())
            c = compare(out, ref)
            c.update(n_vars=b.system.n_vars, rows=b.system.n_rows)
            check(f"{name}[{bi}]", c)
            n_topologies += 1
    print(f"phase3 ok: {n_topologies} topologies, 0 flag mismatches", flush=True)


def phase4(dev, card):
    import numpy as np
    import torch

    from ezpz_tpu_torch.batch import BatchSolver
    from ezpz_tpu_torch.config import Config
    from ezpz_tpu_torch.models.blocks import build_buckets
    from ezpz_tpu_torch.ops import fused_fleet
    from ezpz_tpu_torch.textual import Problem

    with open(os.path.join(HERE, "tests", "cases", "massive_parallel_system",
                           "problem.md")) as fh:
        cs = Problem.from_str(fh.read()).to_constraint_system()
    constraints = [r.constraint for r in cs.constraints]
    x0 = guesses(cs)
    buckets = build_buckets(constraints, len(x0))
    solvers = []
    for b in buckets:
        solver = BatchSolver(b.system, Config(), batch_params=True,
                             precision="mixed", pallas_coarse=True,
                             pallas_fused=True, pallas_trips=3, refine_trips=2)
        xb = torch.as_tensor(x0[b.var_index], device=dev).repeat(COPIES, 1)
        pars = tuple(torch.as_tensor(p, device=dev).repeat(COPIES, 1, 1) for p in b.pars)
        solvers.append((solver, xb, pars))
    sketches = sum(int(xb.shape[0]) for _s, xb, _p in solvers)
    print(f"phase4 buckets: " + json.dumps(
        [{"n_vars": s.system.n_vars, "sketches": int(xb.shape[0])}
         for s, xb, _p in solvers]), flush=True)

    def dispatch(k):
        return [s.solve(xb + k * 1e-9, pb) for s, xb, pb in solvers]

    def dispatch_plain(k):
        return [fused_fleet.fused_fleet_reference(s.plan, xb + k * 1e-9, pb,
                                                  **s.settings())
                for s, xb, pb in solvers]

    # The main-path run: counts from zero, gate on its answers. Its offset
    # (11e-9, bench.py's warm-up index on a one-dispatch chain) lies past
    # the timed reps' and above the 1e-8 tolerance, so every lane iterates.
    warm = 2 * REPS + 1
    fused_fleet.LAUNCHES = 0
    outs = dispatch(warm)
    torch.cuda.synchronize()
    launches = fused_fleet.LAUNCHES
    if launches < len(solvers):
        raise SystemExit(f"chip_smoke: main path launched the kernel {launches} times")
    conv = all(bool(o.converged.all()) for o in outs)
    sat = all(bool(o.satisfied.all()) for o in outs)
    rmax = 0.0
    for (s, xb, pb), o in zip(solvers, outs):
        r, _deg = s.system.residual_and_flags(o.x, pb)
        rmax = max(rmax, float(r.abs().max()))
    iters = max(int(o.iterations.max()) for o in outs)
    print(f"phase4 gate: converged={conv} satisfied={sat} f64_residual_max={rmax!r} "
          f"lm_iterations_max={iters} launches={launches}", flush=True)
    if not (conv and sat and rmax <= 1e-8):
        raise SystemExit("chip_smoke: main path failed the converged/satisfied/1e-8 gate")

    # Kernel against plain at the main path's shapes (not counted above).
    plains = dispatch_plain(warm)
    err = 0.0
    for o, p in zip(outs, plains):
        c = compare((o.x, o.iterations, o.converged, o.satisfied, o.degenerate), p)
        check(f"massive x{COPIES} n_vars={o.x.shape[1]}", c)
        err = max(err, c["x_err"])
    del outs, plains

    def timed(fn):
        walls, device_ms = [], []
        for k in range(REPS):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            fn(k)
            stop.record()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            device_ms.append(start.elapsed_time(stop))
        return sorted(walls)[REPS // 2], sorted(device_ms)[REPS // 2], walls

    kw, kms, kwalls = timed(dispatch)
    pw, pms, pwalls = timed(dispatch_plain)
    for label, wall, ms, walls in (("kernel", kw, kms, kwalls), ("plain", pw, pms, pwalls)):
        print(f"phase4 {label}: {COPIES / wall!r} solves/s of the 2400-var system "
              f"({sketches / wall!r} sketch solves/s), median {wall * 1e3!r} ms wall, "
              f"{ms!r} ms CUDA events, reps {[round(w * 1e3, 3) for w in walls]} ms; "
              f"card: {card}", flush=True)
    return dict(launches=launches, max_abs_err=err, ms=kms, plain_ms=pms)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    import ezpz_tpu_torch  # noqa: F401  (fails outside a checkout)
    from ezpz_tpu_torch.ops import _build

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}",
          flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    print(f"phase2 build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(so, HERE)}",
          flush=True)
    for line in ptxas_summary(str(so) + ".log"):
        print("phase2 ptxas " + line, flush=True)

    phase3(dev)
    rec = phase4(dev, card)
    print(json.dumps({"kernels": [{
        "name": "fused_fleet",
        "route": "cuda",
        "source": "ezpz_tpu_torch/csrc/fused_fleet.cu",
        "replaces": "ezpz_tpu/ops/pallas_fleet.py:898",
        "launches": rec["launches"],
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
