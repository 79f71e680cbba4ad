#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ezpz_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. the card (``nvidia-smi`` name and power limit) and the CUDA runtime;
   no GPU, no run;
2. build the fleet kernels (``csrc/fused_fleet.cu``, ``csrc/coarse_fleet.cu``)
   with nvcc, one compiler per source, and print each instantiation's
   registers, stack frame and spills, and its resident threads per SM;
3. the fused kernel against its plain PyTorch version on the card, on every
   bucket of every corpus fixture plus ``rect_chain(8)`` (37 topologies)
   and three big ones the kernel gate admits: ``chain(40)`` (80
   variables), ``chain(128)`` (256 instances, the gate's edge) and
   ``rect_chain(42)`` (254 instances): 4096 seeded perturbations
   (sigma 1e-3) of the guesses each; converged, satisfied and degenerate
   must be equal lane for lane, iterations equal on at least 99.9% of
   lanes, coordinates within 1e-6 where both converged;
3b. on the same 40 topologies and lanes: the coarse kernel against its
   plain version (iterations, converged and degenerate equal lane for
   lane, coordinates within 1e-6, bit equality reported), and the whole
   coarse path (``BatchSolver(pallas_coarse=True, pallas_fused=False)``:
   kernel, then the batched f64-residual refinement) against the same path
   with the plain coarse version, as in phase 3;
3c. each kernel alone (CUDA events, median of 5) on the topologies above
   the main path's shapes that the big-topology kernel takes (``square``
   and ``chamfer_square`` of the corpus, ``rect_chain(8)``, ``chain(40)``)
   and on two that ``<8,8>`` takes (``parallelogram``, ``arc_length``), at
   MIDSIZE_B seeded perturbations each (``MIDSIZE``; ``phase3c`` also runs
   alone, on any checkout whose package has the same wrappers);
4. the fused main path of ``bench.py`` through the port: the
   ``massive_parallel_system`` fixture at 8192 copies (9.8 M one-variable
   and 4.9 M two-variable sketches) via ``Problem.from_str`` ->
   ``to_constraint_system`` -> ``build_buckets`` -> ``BatchSolver(...,
   precision="mixed", pallas_fused=True, pallas_trips=3,
   refine_trips=2).solve`` on CUDA tensors. Every lane converged and
   satisfied, the f64 residual recomputed by ``residual_and_flags`` <=
   1e-8, the kernel launched; then 5 timed reps with fresh inputs of the
   kernel alone (inputs made before the first event), of the plain
   version, and of the whole ``solve`` call;
5. the coarse main path (``bench.py``'s ``BENCH_FUSED=0``): the same
   fixture and copies through ``BatchSolver(..., precision="mixed",
   pallas_coarse=True, pallas_fused=False, pallas_trips=3).solve``. The
   same gate; the coarse kernel launched once per bucket and the fused one
   not at all; then 5 timed reps of the path, of its coarse kernel and
   refinement separately, and of the path with the plain coarse version;
6. the public API on the card (``phase6``):
   (a) every corpus fixture through ``Problem.from_str(...)
   .to_constraint_system().solve_with_config_analysis(Config(),
   device=...)`` on the card and on the CPU: converged, unsatisfied,
   underconstrained and warnings equal, coordinates within 1e-6 on fully
   constrained fixtures, and the card's iteration count equal to the pin
   in ``tests/golden_iterations.json``;
   (b) ``massive_parallel_system`` (2,400 variables) and the same sketch
   tiled 16 times with offset ids (38,400 variables) through
   ``ezpz_tpu_torch.solve`` on the card (the ``BlockProgram`` route):
   converged, all satisfied, 2 iterations; then the CLI's protocol,
   ``time_resolves`` synchronous and pipelined (20 repeats), in us per
   solve, on the card and on the CPU for ``tiny``, ``two_rectangles`` and
   ``massive_parallel_system``, and on the card for the tiled sketch (10
   repeats: its host path is long); on the card each also once under
   ``torch.profiler`` (launches, device busy time, idle share);
   (c) the tiled sketch through ``BlockSolver(precision="mixed",
   pallas_fused=True)`` and ``(pallas_coarse=True)`` on the card, counts
   from zero: each kernel launched once per bucket its gate admits, the
   other not at all, the bench gate on the whole 38,400-variable system
   (``residual_and_flags``), x within 1e-6 of ``BlockSolver(precision=
   "f64")``; and ``MultiTopologySolver`` on the massive fixture's buckets
   equal to per-bucket ``BatchSolver`` results (flags, iterations, x
   within 1e-12);
   (d) ``BatchSolver.solve_analysis`` on the buckets of
   ``underconstrained`` (its pinned point q; p is in no constraint),
   ``perpdist`` and ``parallelogram`` (2 and 4 free variables) and
   ``square`` at 4096 seeded perturbations each, on the card and on the
   CPU: converged flags and underconstrained lists equal lane for lane;
7. the serving path on the card (``phase7``):
   (a) the native parser and union-find (``ezpz_tpu_torch/native``) built
   with g++ and loaded, or the phase fails; every fixture parses to the
   same ``Problem`` natively and in Python, the tiled sketch's union-find
   gives the same roots both ways, each timed against Python;
   (b) ``serve.SolverService()`` with its defaults (the card, mixed, the
   fused kernel): every fixture sent twice (cold, warm) against a CPU f64
   service (flags equal, points within 1e-6 when fully constrained), one
   fused launch per request the kernel gate admits and none otherwise
   (``massive_parallel_system``, over the gate, answered on the batched
   mixed path); a burst of BURST perturbed ``two_rectangles`` requests
   from CLIENTS threads, mixed and then f64 per request, against
   ``BatchSolver(precision="f64")`` on the CPU, one fused launch per
   batch, with requests per second, p50 and p99 latency, and beside it
   the same lanes as one ``BatchSolver.solve`` (CUDA events) and the
   host's parse time; ``serve.benchmark`` (sequential requests);
   (c) the HTTP front end (``serve.make_handler``): routes, the
   X-Precision header, ``/healthz``, 404 and the 400 error body;
   (d) the embed probes on the card against the CPU, timed.

The line before the last is a JSON record per kernel: launches in its main
path's run, max |x_kernel - x_plain| at the main path's shapes, ms per
main-path solve for the kernel and for its plain version (CUDA events,
median of 5), and the least time the card could take (``bound_ms``: the
larger of the bytes each kernel must move over 3.35 TB/s and a lower
bound of its operations over 67 TFLOP/s in f32 and 34 TFLOP/s in f64,
counted from this run's inputs and iteration counts). No single PyTorch
call computes an LM fleet solve, so ``library_ms`` is null. The last line
is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
API_FIXTURES = ("tiny", "two_rectangles", "massive_parallel_system")
API_ITERS = 20
TILES = 16
TILED_ITERS = 10
ANALYSIS_FIXTURES = ("underconstrained", "perpdist", "square", "parallelogram")
ANALYSIS_B = 4096
COPIES = 8192
REPS = 5
INNER = 4
PHASE3_B = 4096
MIDSIZE_B = 262144
MIDSIZE = ("arc_length[0]", "chamfer_square[0]", "parallelogram[0]", "square[0]",
           "rect_chain(8)[0]", "chain(40)[0]")
X_TOL = 1e-6
ITER_EQUAL_MIN = 0.999
# Phase 7: the service's burst, its sequential rate, the embed probe.
BURST = 4096
CLIENTS = 64
BURST_SIGMA = 1e-2
BURST_WINDOW_MS = 20.0
SEQUENTIAL_N = 50
EMBED_CALLS = 20
# NVIDIA H100 SXM data sheet: memory rate, f32 and f64 rates outside the
# tensor cores (at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log_path):
    """One line per kernel instantiation from nvcc's -Xptxas -v log:
    registers, stack frame and spills."""
    if not os.path.exists(log_path):
        return []
    out, name = [], None
    for line in open(log_path):
        m = re.search(r"Compiling entry function '.*?(fused|coarse)_(small|big)_kernel"
                      r"(?:ILi(\d+)ELi(\d+)E)?", line)
        if m:
            shape = f"<{m.group(3)},{m.group(4)}>" if m.group(3) else ""
            name = f"{m.group(1)}_{m.group(2)}_kernel{shape}"
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


def chain(n_points):
    """A pinned chain of unit distances along x (tests/test_torch_cuda.py):
    2 n_points variables, 2 n_points instances."""
    import numpy as np

    from ezpz_tpu_torch import Constraint, DatumLineSegment, DatumPoint

    pts = [DatumPoint(2 * i, 2 * i + 1) for i in range(n_points)]
    cons = [Constraint.Fixed(0, 0.0), Constraint.Fixed(1, 0.0)]
    x0 = np.zeros(2 * n_points)
    for i in range(1, n_points):
        cons.append(Constraint.Distance(pts[i - 1], pts[i], 1.0))
        cons.append(Constraint.Horizontal(DatumLineSegment(pts[i - 1], pts[i])))
        x0[2 * i] = i + 0.01 * (-1) ** i
    return cons, x0


def topologies():
    """(label, constraints, x0) for every corpus fixture, rect_chain(8), and
    the big topologies at and below the kernel gate's edge."""
    for name in fixture_names():
        cs = system_of(fixture_text(name))
        x0 = guesses(cs)
        yield name, [r.constraint.set_from_initial_values(x0) for r in cs.constraints], x0
    cons, x0 = rect_chain(8)
    yield "rect_chain(8)", cons, x0
    for k in (40, 128):
        cons, x0 = chain(k)
        yield f"chain({k})", cons, x0
    cons, x0 = rect_chain(42)
    yield "rect_chain(42)", cons, x0


def fleets(dev, B=PHASE3_B, labels=None):
    """(label, bucket, x (B, n) and pars on ``dev``) for every bucket of
    every topology (or those named in ``labels``), from one seed sequence."""
    import numpy as np
    import torch

    from ezpz_tpu_torch.models.blocks import build_buckets

    seed = 0
    for name, cons, x0 in topologies():
        for bi, b in enumerate(build_buckets(cons, len(x0))):
            rng = np.random.default_rng(seed)
            seed += 1
            label = f"{name}[{bi}]"
            if labels is not None and label not in labels:
                continue
            k = np.arange(B) % len(b.components)
            xb = torch.as_tensor(
                x0[b.var_index[k]] + rng.normal(0, 1e-3, (B, b.system.n_vars)),
                device=dev)
            pars = tuple(torch.as_tensor(np.asarray(p)[k], device=dev) for p in b.pars)
            yield label, b, xb, pars


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
    print(f"{label}: " + json.dumps(c), flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: kernel disagrees with plain on {label}")


def compare_coarse(out, ref):
    """The coarse kernel against its plain version: every lane's
    iterations, converged and degenerate flags, and the f32 point (NaN
    where the plain version has NaN)."""
    import torch

    x, it, conv, deg = out
    rx, rit, rconv, rdeg = ref
    nan_equal = bool(torch.equal(torch.isnan(x), torch.isnan(rx)))
    fin = torch.isfinite(x) & torch.isfinite(rx)
    err = float((x - rx).abs()[fin].max()) if bool(fin.any()) else 0.0
    return dict(
        lanes=int(conv.numel()),
        iter_mismatch=int((it != rit).sum()),
        conv_mismatch=int((conv != rconv).sum()),
        deg_mismatch=int((deg != rdeg).any(dim=1).sum()),
        nan_equal=nan_equal,
        x_err=err,
        bit_equal_x=bool(torch.equal(x, rx)),
    )


def check_coarse(label, c):
    ok = (c["iter_mismatch"] == 0 and c["conv_mismatch"] == 0
          and c["deg_mismatch"] == 0 and c["nan_equal"] and c["x_err"] <= X_TOL)
    print(f"{label}: " + json.dumps(c), flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: coarse kernel disagrees with plain on {label}")


def coarse_solver(system):
    from ezpz_tpu_torch.batch import BatchSolver
    from ezpz_tpu_torch.config import Config

    return BatchSolver(system, Config(), batch_params=True, precision="mixed",
                       pallas_coarse=True, pallas_fused=False, pallas_trips=3)


def fused_solver(system):
    from ezpz_tpu_torch.batch import BatchSolver
    from ezpz_tpu_torch.config import Config

    return BatchSolver(system, Config(), batch_params=True, precision="mixed",
                       pallas_coarse=True, pallas_fused=True, pallas_trips=3,
                       refine_trips=2)


def as_tuple(res):
    return (res.x, res.iterations, res.converged, res.satisfied, res.degenerate)


def route(plan):
    """Which instantiation takes ``plan``."""
    from ezpz_tpu_torch.ops import _build

    shape = _build.small_shape(plan)
    return f"small<{shape[0]},{shape[1]}>" if shape else "big"


def phase3(dev):
    import torch

    from ezpz_tpu_torch.ops import fused_fleet

    n_topologies = 0
    for label, b, xb, pars in fleets(dev):
        solver = fused_solver(b.system)
        out = fused_fleet.fused_fleet_solve(solver.plan, xb, pars, **solver.settings())
        torch.cuda.synchronize()
        ref = fused_fleet.fused_fleet_reference(solver.plan, xb, pars, **solver.settings())
        c = compare(out, ref)
        c.update(n_vars=b.system.n_vars, rows=b.system.n_rows, kernel=route(solver.plan))
        check(f"phase3 {label}", c)
        n_topologies += 1
    print(f"phase3 ok: {n_topologies} topologies, 0 flag mismatches", flush=True)


def phase3b(dev):
    import torch

    from ezpz_tpu_torch.ops import coarse_fleet

    n_topologies = 0
    for label, b, xb, pars in fleets(dev):
        solver = coarse_solver(b.system)
        out = coarse_fleet.coarse_fleet_solve(solver.plan, xb, pars, **solver.coarse_settings())
        torch.cuda.synchronize()
        ref = coarse_fleet.coarse_fleet_reference(solver.plan, xb, pars,
                                                  **solver.coarse_settings())
        c = compare_coarse(out, ref)
        c.update(n_vars=b.system.n_vars, rows=b.system.n_rows, kernel=route(solver.plan))
        check_coarse(f"phase3b kernel {label}", c)
        path = solver.solve(xb, pars)
        plain = solver.refine(ref[0], ref[1], ref[3], pars)
        check(f"phase3b path {label}", compare(as_tuple(path), as_tuple(plain)))
        n_topologies += 1
    print(f"phase3b ok: {n_topologies} topologies, 0 flag mismatches", flush=True)


def phase3c(dev, card, labels=MIDSIZE):
    """Each kernel alone on the mid-size topologies ``labels``, MIDSIZE_B
    lanes each: ms per solve (``kernel_ms``) and ns per lane."""
    for label, b, xb, pars in fleets(dev, MIDSIZE_B, labels):
        solvers = [(fused_solver(b.system), xb, pars)]
        fms = kernel_ms(solvers, "fused")
        solvers = [(coarse_solver(b.system), xb, pars)]
        cms = kernel_ms(solvers, "coarse")
        print(f"phase3c {label} n_vars={b.system.n_vars} rows={b.system.n_rows} "
              f"lanes={MIDSIZE_B}: fused kernel alone {fms!r} ms "
              f"({fms * 1e6 / MIDSIZE_B!r} ns/lane), coarse kernel alone {cms!r} ms "
              f"({cms * 1e6 / MIDSIZE_B!r} ns/lane) (CUDA events around {INNER} solves on "
              f"inputs made before, median of {REPS}); card: {card}", flush=True)


def massive(dev, make_solver):
    """(solver, x (COPIES*k, n), pars) per bucket of the massive fixture."""
    import torch

    from ezpz_tpu_torch.models.blocks import build_buckets
    from ezpz_tpu_torch.textual import Problem

    with open(os.path.join(HERE, "tests", "cases", "massive_parallel_system",
                           "problem.md")) as fh:
        cs = Problem.from_str(fh.read()).to_constraint_system()
    x0 = guesses(cs)
    out = []
    for b in build_buckets([r.constraint for r in cs.constraints], len(x0)):
        xb = torch.as_tensor(x0[b.var_index], device=dev).repeat(COPIES, 1)
        pars = tuple(torch.as_tensor(p, device=dev).repeat(COPIES, 1, 1) for p in b.pars)
        out.append((make_solver(b.system), xb, pars))
    return out


def gate(label, solvers, outs):
    """The bench gate: every lane converged and satisfied, f64 residual
    recomputed outside the solver <= 1e-8."""
    conv = all(bool(o.converged.all()) for o in outs)
    sat = all(bool(o.satisfied.all()) for o in outs)
    rmax = 0.0
    for (s, _xb, pb), o in zip(solvers, outs):
        r, _deg = s.system.residual_and_flags(o.x, pb)
        rmax = max(rmax, float(r.abs().max()))
    iters = max(int(o.iterations.max()) for o in outs)
    print(f"{label} gate: converged={conv} satisfied={sat} f64_residual_max={rmax!r} "
          f"lm_iterations_max={iters}", flush=True)
    if not (conv and sat and rmax <= 1e-8):
        raise SystemExit(f"chip_smoke: {label} failed the converged/satisfied/1e-8 gate")


def timed(fn, marks=1):
    """REPS calls of ``fn(k, events)`` with fresh inputs (rep index k);
    ``fn`` records the ``marks + 1`` CUDA events it is given. Returns
    (median host seconds, median ms between consecutive events per
    segment, host seconds of every rep)."""
    import torch

    walls, segs = [], []
    for k in range(REPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(marks + 1)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(k, ev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        segs.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
    med = [sorted(seg[i] for seg in segs)[REPS // 2] for i in range(marks)]
    return sorted(walls)[REPS // 2], med, walls


def around(dispatch):
    """A ``timed`` body: the whole of ``dispatch(k)`` between two events."""
    def body(k, ev):
        ev[0].record()
        dispatch(k)
        ev[1].record()
    return body


def report(label, wall, ms, walls, sketches, card):
    print(f"{label}: {COPIES / wall!r} solves/s of the 2400-var system "
          f"({sketches / wall!r} sketch solves/s), median {wall * 1e3!r} ms wall, "
          f"{ms!r} ms CUDA events, reps {[round(w * 1e3, 3) for w in walls]} ms; "
          f"card: {card}", flush=True)


def step_ops(plan):
    """A lower bound of one LM step's operations for one lane, from the
    plan: one per Jacobian entry, the JtJ lower triangle and Jtr products
    and sums, the Crout factorization on the planned fill, both triangular
    solves and the step's update; and (separately) the residual rows'
    evaluation at the trial point with its sum of squares. Kernel-specific
    residual arithmetic beyond one operation per row is not counted."""
    import numpy as np

    from ezpz_tpu_torch.ops.fleet_plan import INST_DIM, INST_NV

    jac = 0
    for row in plan.inst:
        nv, dim = int(row[INST_NV]), int(row[INST_DIM])
        jac += dim * nv + 2 * dim * nv + 2 * dim * nv * (nv + 1) // 2
    nz = np.tril(plan.nzl.astype(bool))
    factor = 0
    for i in range(plan.n_vars):
        for j in range(i + 1):
            if nz[i, j]:
                factor += 1 + 2 * int((nz[i, :j] & nz[j, :j]).sum())
    solve = 2 * (2 * int(nz.sum()) - plan.n_vars)
    return jac + factor + solve + 3 * plan.n_vars, 3 * plan.n_rows


def table_bytes(plan):
    """Bytes of the topology tables the routed instantiation reads: the
    fields of SmallTopo<NV, NI> (csrc/fleet_common.cuh) for an exact
    shape, ``FleetPlan.big_tables`` for the big-topology kernel."""
    from ezpz_tpu_torch.ops import _build
    from ezpz_tpu_torch.ops.fleet_plan import KI_SLOTS

    shape = _build.small_shape(plan)
    if shape is None:
        return sum(a.nbytes for a in plan.big_tables())
    nv, ni = shape
    # inst[NI][KI_SLOTS], w32[NI], w64[NI], perm[NV], fill, n, n_cons, P
    return ni * (4 * KI_SLOTS + 4 + 8) + 4 * nv + 8 + 3 * 4


def bound_ms(kind, solvers, outs):
    """The least time the card could take for one main-path solve of a
    kernel: the larger of its bytes (inputs read once, outputs written
    once, the topology tables the kernel reads included) over the memory
    rate and a lower bound of its operations (``step_ops`` times this
    run's steps per lane: at least the reported iterations) over the f32
    and f64 rates. Returns (ms, "bytes" or "operations")."""
    nbytes, f32_ops, f64_ops = 0, 0, 0
    for (s, xb, _pb), o in zip(solvers, outs):
        plan = s.plan
        B, n = xb.shape
        per_lane_in = 8 * n + 8 * plan.n_par
        if kind == "coarse":
            per_lane_out = 4 * n + 4 + 1 + plan.n_constraints
        else:
            per_lane_out = 8 * n + 4 + 1 + 2 * plan.n_constraints
        nbytes += B * (per_lane_in + per_lane_out) + table_bytes(plan)
        steps = int(o[1].sum())
        jac_ops, res_ops = step_ops(plan)
        f32_ops += steps * jac_ops + B * plan.n_rows
        if kind == "coarse":
            f32_ops += steps * res_ops
        else:
            f64_ops += steps * res_ops + B * plan.n_rows
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S
    print(f"bound {kind}: {nbytes} bytes -> {t_bytes * 1e3!r} ms; {f32_ops} f32 + "
          f"{f64_ops} f64 operations -> {t_ops * 1e3!r} ms", flush=True)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase4(dev, card):
    import torch

    from ezpz_tpu_torch.ops import fused_fleet

    solvers = massive(dev, fused_solver)
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
    print(f"phase4 launches: fused_fleet={launches}", flush=True)
    if launches < len(solvers):
        raise SystemExit(f"chip_smoke: main path launched the kernel {launches} times")
    gate("phase4", solvers, outs)

    # Kernel against plain at the main path's shapes (not counted above).
    plains = dispatch_plain(warm)
    err = 0.0
    for o, p in zip(outs, plains):
        c = compare(as_tuple(o), p)
        check(f"phase4 massive x{COPIES} n_vars={o.x.shape[1]}", c)
        err = max(err, c["x_err"])
    bound, bound_by = bound_ms("fused", solvers, [as_tuple(o) for o in outs])
    del outs, plains

    kms = kernel_ms(solvers, "fused")
    pms = kernel_ms(solvers, "fused", plain=True)
    sw, (sms,), swalls = timed(around(dispatch))
    print(f"phase4 kernel alone {kms!r} ms, plain version alone {pms!r} ms per main-path "
          f"solve (CUDA events around {INNER} solves on inputs made before, median of "
          f"{REPS}); card: {card}", flush=True)
    report("phase4 path (solve calls, input offsets included)", sw, sms, swalls,
           sketches, card)
    return dict(launches=launches, max_abs_err=err, ms=kms, plain_ms=pms,
                bound_ms=bound, bound_by=bound_by)


def phase5(dev, card):
    import torch

    from ezpz_tpu_torch.ops import coarse_fleet, fused_fleet

    solvers = massive(dev, coarse_solver)
    sketches = sum(int(xb.shape[0]) for _s, xb, _p in solvers)

    def dispatch(k):
        return [s.solve(xb + k * 1e-9, pb) for s, xb, pb in solvers]

    def coarse_plain(k):
        return [coarse_fleet.coarse_fleet_reference(s.plan, xb + k * 1e-9, pb,
                                                    **s.coarse_settings())
                for s, xb, pb in solvers]

    # The main-path run, counts from zero (offset as in phase 4).
    warm = 2 * REPS + 1
    coarse_fleet.LAUNCHES = 0
    fused_fleet.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    outs = dispatch(warm)
    torch.cuda.synchronize()
    launches, fused_launches = coarse_fleet.LAUNCHES, fused_fleet.LAUNCHES
    print(f"phase5 launches: coarse_fleet={launches} fused_fleet={fused_launches}; "
          f"peak device memory {torch.cuda.max_memory_allocated()!r} bytes", flush=True)
    if launches != len(solvers) or fused_launches != 0:
        raise SystemExit(f"chip_smoke: coarse main path launched coarse_fleet {launches} "
                         f"and fused_fleet {fused_launches} times")
    gate("phase5", solvers, outs)

    # Kernel against plain at the main path's shapes (not counted above):
    # the coarse kernel alone, then the whole path.
    err = 0.0
    kernel_outs = []
    for (s, xb, pb), p, path in zip(solvers, coarse_plain(warm), outs):
        o = coarse_fleet.coarse_fleet_solve(s.plan, xb + warm * 1e-9, pb, **s.coarse_settings())
        c = compare_coarse(o, p)
        check_coarse(f"phase5 kernel massive x{COPIES} n_vars={s.system.n_vars}", c)
        err = max(err, c["x_err"])
        kernel_outs.append(o)
        plain = s.refine(p[0], p[1], p[3], pb)
        check(f"phase5 path massive x{COPIES} n_vars={s.system.n_vars}",
              compare(as_tuple(path), as_tuple(plain)))
    bound, bound_by = bound_ms("coarse", solvers, kernel_outs)
    del outs, kernel_outs

    def split(plain):
        """The coarse kernel (or its plain version) and the refinement,
        each between its own events, on inputs made before the first."""
        def body(k, ev):
            inputs = [(s, xb + k * 1e-9, pb) for s, xb, pb in solvers]
            ev[0].record()
            if plain:
                firsts = [coarse_fleet.coarse_fleet_reference(s.plan, x, pb,
                                                              **s.coarse_settings())
                          for s, x, pb in inputs]
                firsts = [(f[0], f[1], f[3]) for f in firsts]
            else:
                firsts = [s.coarse(x, pb) for s, x, pb in inputs]
            ev[1].record()
            for (s, _x, pb), f in zip(inputs, firsts):
                s.refine(*f, pb)
            ev[2].record()
        return body

    pw, (pms,), pwalls = timed(around(dispatch))
    _w, (cms, rms), _ws = timed(split(plain=False), marks=2)
    qw, (qcms, qrms), qwalls = timed(split(plain=True), marks=2)
    report("phase5 path", pw, pms, pwalls, sketches, card)
    report("phase5 path with the plain coarse version", qw, qcms + qrms, qwalls, sketches, card)
    print(f"phase5 split: coarse kernel {cms!r} ms, refine {rms!r} ms; plain coarse "
          f"{qcms!r} ms, refine {qrms!r} ms (CUDA events, median of {REPS}); card: {card}",
          flush=True)
    kms = kernel_ms(solvers, "coarse")
    kpms = kernel_ms(solvers, "coarse", plain=True)
    print(f"phase5 coarse kernel alone {kms!r} ms, plain version alone {kpms!r} ms per "
          f"main-path solve (CUDA events around {INNER} solves on inputs made before, "
          f"median of {REPS}); card: {card}", flush=True)
    return dict(launches=launches, max_abs_err=err, ms=kms, plain_ms=kpms,
                bound_ms=bound, bound_by=bound_by)


def fixture_text(name):
    with open(os.path.join(HERE, "tests", "cases", name, "problem.md")) as fh:
        return fh.read()


def tiled_text(name, copies):
    """A fixture whose points are all named ``p<i>`` repeated ``copies``
    times, copy c's point i renamed ``p<i + c * n_points>``: independent
    copies with offset variable ids."""
    text = fixture_text(name)
    head, tail = text.split("# guesses")
    n_points = len(re.findall(r"^point p\d+$", head, flags=re.M))

    def shifted(block, c):
        return re.sub(r"\bp(\d+)\b", lambda m: f"p{int(m.group(1)) + c * n_points}", block)

    body = head.replace("# constraints", "")
    return ("# constraints\n" + "".join(shifted(body, c) for c in range(copies))
            + "# guesses\n" + "".join(shifted(tail, c) for c in range(copies)))


def system_of(text):
    from ezpz_tpu_torch.textual import Problem

    return Problem.from_str(text).to_constraint_system()


def outcome_key(res):
    """What must be equal between two devices' ``OutcomeAnalysis``."""
    o = res.outcome
    return (o.converged, o.unsatisfied, res.analysis.underconstrained(),
            [(w.about_constraint, w.content.value) for w in o.warnings],
            o.priority_solved, o.num_vars, o.num_eqs)


def phase6a(dev):
    """The corpus through the textual API on the card and on the CPU.
    Returns the names of the fully constrained fixtures."""
    from ezpz_tpu_torch.config import Config

    with open(os.path.join(HERE, "tests", "golden_iterations.json")) as fh:
        pins = json.load(fh)
    bad, fully = [], set()
    for name in sorted(pins):
        cs = system_of(fixture_text(name))
        card = cs.solve_with_config_analysis(Config(), device=dev)
        cpu = cs.solve_with_config_analysis(Config(), device="cpu")
        full = not cpu.analysis.is_underconstrained()
        if full:
            fully.add(name)
        dx = max((abs(a - b) for a, b in zip(card.outcome.final_values,
                                             cpu.outcome.final_values)), default=0.0)
        same = outcome_key(card) == outcome_key(cpu)
        on_pin = card.outcome.iterations == pins[name]
        print(f"phase6a {name}: iterations card {card.outcome.iterations} cpu "
              f"{cpu.outcome.iterations} pin {pins[name]}; outcome equal {same}; "
              f"fully constrained {full}, max |x_card - x_cpu| {dx!r}", flush=True)
        if not (same and on_pin and (dx <= X_TOL or not full)):
            bad.append(name)
    if bad:
        raise SystemExit(f"chip_smoke: the API on the card disagrees with the CPU or "
                         f"misses a pinned iteration count on {bad}")
    print(f"phase6a ok: {len(pins)} fixtures equal on card and CPU, card on every pin",
          flush=True)
    return fully


def phase6b(dev, card):
    """``solve`` on the decomposed route at full size, and the CLI's timing
    protocol on the card and on the CPU. Returns the card's synchronous us
    per solve by sketch."""
    import ezpz_tpu_torch
    from ezpz_tpu_torch import api
    from ezpz_tpu_torch.config import Config
    from ezpz_tpu_torch.models.blocks import BlockProgram

    tiled = system_of(tiled_text("massive_parallel_system", TILES))
    for label, cs in (("massive_parallel_system", system_of(fixture_text(
            "massive_parallel_system"))), (f"massive x{TILES} tiled", tiled)):
        out = ezpz_tpu_torch.solve(cs.constraints, cs.initial_guesses, device=dev)
        n = len(cs.initial_guesses)
        program, _ = api._get_system_and_solver(
            [r.constraint for r in cs.constraints], [1.0] * len(cs.constraints), n,
            Config().max_iterations, device=dev)
        print(f"phase6b solve {label}: {n} variables, route "
              f"{type(program).__name__} ({getattr(program, 'n_components', 1)} components), "
              f"converged={out.converged} unsatisfied={len(out.unsatisfied)} "
              f"iterations={out.iterations}", flush=True)
        if not (isinstance(program, BlockProgram) and out.converged
                and not out.unsatisfied and out.iterations == 2):
            raise SystemExit(f"chip_smoke: solve failed on {label}")

    runs = [(name, system_of(fixture_text(name)), d, API_ITERS) for name in API_FIXTURES
            for d in (dev, "cpu")]
    runs.append((f"massive x{TILES} tiled", tiled, dev, TILED_ITERS))
    card_us = {}
    for name, cs, d, iters in runs:
        cs.solve_with_config(Config(), device=d)  # build the solver once, untimed
        sync = cs.time_resolves(Config(), iters=iters, device=d)
        piped = cs.time_resolves(Config(), iters=iters, pipelined=True, device=d)
        where = "card" if str(d) != "cpu" else "cpu"
        print(f"phase6b time_resolves {name} on the {where}: {sync * 1e6!r} us/solve "
              f"synchronous, {piped * 1e6!r} us/solve pipelined (mean of {iters}); "
              f"card: {card}", flush=True)
        if where == "card":
            card_us[name] = sync * 1e6
            print(f"phase6b profile {name} on the card: {profile_solve(cs, d)}", flush=True)
    return card_us


def profile_solve(cs, dev):
    """One warm ``solve_with_config`` on the card under ``torch.profiler``:
    kernel launches, device-to-host copies, the kernels' summed device time
    and the wall time (profiler overhead included), and the device's idle
    share of that wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ezpz_tpu_torch.config import Config

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cs.solve_with_config(Config(), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = copies = 0
    device_us = 0.0
    for e in prof.key_averages():
        if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx"):
            launches += e.count
        elif e.key == "cudaMemcpyAsync":
            copies += e.count
        if e.device_type == DeviceType.CUDA:
            device_us += getattr(e, "self_device_time_total", 0.0)
    return (f"{launches} kernel launches, {copies} cudaMemcpyAsync, device busy "
            f"{device_us / 1e3!r} ms of {wall * 1e3!r} ms wall (profiled), idle share "
            f"{1 - device_us / 1e6 / wall!r}")


def phase6c(dev):
    """``BlockSolver`` in its kernel modes on the tiled sketch, and
    ``MultiTopologySolver`` against per-bucket ``BatchSolver``s."""
    import numpy as np
    import torch

    from ezpz_tpu_torch.batch import BatchSolver, MultiTopologySolver
    from ezpz_tpu_torch.config import Config
    from ezpz_tpu_torch.models.blocks import BlockSolver, build_buckets
    from ezpz_tpu_torch.models.compiled import compile_system
    from ezpz_tpu_torch.ops import coarse_fleet, fused_fleet

    cs = system_of(tiled_text("massive_parallel_system", TILES))
    x0 = guesses(cs)
    cons = [r.constraint.set_from_initial_values(x0) for r in cs.constraints]
    whole = compile_system(cons, len(x0))
    ref = BlockSolver(cons, len(x0), precision="f64", device=dev).solve(x0)
    for mode, mod, other in (("fused", fused_fleet, coarse_fleet),
                             ("coarse", coarse_fleet, fused_fleet)):
        solver = BlockSolver(cons, len(x0), precision="mixed", pallas_coarse=True,
                             pallas_fused=mode == "fused", device=dev)
        admitted = sum(s.kernel_ok for s in solver._solvers)
        fused_fleet.LAUNCHES = coarse_fleet.LAUNCHES = 0
        out = solver.solve(x0)
        torch.cuda.synchronize()
        launches, others = mod.LAUNCHES, other.LAUNCHES
        r, _deg = whole.residual_and_flags(torch.as_tensor(out.x, device=dev)[None])
        rmax = float(r.abs().max())
        dx = float(np.abs(out.x - ref.x).max())
        print(f"phase6c BlockSolver {mode} x{TILES} tiled: {len(solver.buckets)} buckets, "
              f"{admitted} admitted, launches {mode}_fleet={launches} other={others}; "
              f"converged={out.converged} satisfied={bool(out.satisfied.all())} "
              f"f64_residual_max={rmax!r} iterations={out.iterations}; "
              f"max |x - x_f64| {dx!r}", flush=True)
        if not (admitted > 0 and launches == admitted and others == 0 and out.converged
                and bool(out.satisfied.all()) and rmax <= 1e-8 and dx <= X_TOL):
            raise SystemExit(f"chip_smoke: BlockSolver {mode} failed on the tiled sketch")

    cs = system_of(fixture_text("massive_parallel_system"))
    x0 = guesses(cs)
    buckets = build_buckets([r.constraint for r in cs.constraints], len(x0))
    x0s = [torch.as_tensor(x0[b.var_index] + 1e-3, device=dev) for b in buckets]
    parss = [tuple(torch.as_tensor(p, device=dev) for p in b.pars) for b in buckets]
    multi = MultiTopologySolver([b.system for b in buckets], Config(), device=dev)
    for b, m, xb, pb in zip(buckets, multi.solve(x0s, parss), x0s, parss):
        one = BatchSolver(b.system, Config(), batch_params=True, device=dev).solve(xb, pb)
        flags = all(torch.equal(getattr(m, k), getattr(one, k)) for k in
                    ("iterations", "converged", "satisfied", "degenerate"))
        dx = float((m.x - one.x).abs().max())
        print(f"phase6c MultiTopologySolver bucket n_vars={b.system.n_vars} "
              f"lanes={len(b.components)}: flags and iterations equal {flags}, "
              f"max |dx| {dx!r}", flush=True)
        if not (flags and dx <= 1e-12):
            raise SystemExit("chip_smoke: MultiTopologySolver disagrees with BatchSolver")


def phase6d(dev):
    """``BatchSolver.solve_analysis`` on the card against the CPU."""
    import numpy as np
    import torch

    from ezpz_tpu_torch.batch import BatchSolver
    from ezpz_tpu_torch.config import Config
    from ezpz_tpu_torch.models.blocks import build_buckets

    seed = 100
    for name in ANALYSIS_FIXTURES:
        cs = system_of(fixture_text(name))
        x0 = guesses(cs)
        cons = [r.constraint.set_from_initial_values(x0) for r in cs.constraints]
        for bi, b in enumerate(build_buckets(cons, len(x0))):
            rng = np.random.default_rng(seed)
            seed += 1
            k = np.arange(ANALYSIS_B) % len(b.components)
            xb = x0[b.var_index[k]] + rng.normal(0, 1e-3, (ANALYSIS_B, b.system.n_vars))
            pars = tuple(np.asarray(p)[k] for p in b.pars)
            outs = []
            for d in (dev, "cpu"):
                res, an = BatchSolver(b.system, Config(), batch_params=True,
                                      device=d).solve_analysis(xb, pars)
                outs.append((res.converged.cpu(), [a.underconstrained() for a in an]))
            (cc, ca), (pc, pa) = outs
            lists_equal = sum(a == p for a, p in zip(ca, pa))
            print(f"phase6d {name}[{bi}] n_vars={b.system.n_vars} lanes={ANALYSIS_B}: "
                  f"converged equal {bool(torch.equal(cc, pc))}, underconstrained lists "
                  f"equal on {lists_equal}/{ANALYSIS_B} lanes, lists on the card "
                  f"{sorted(set(map(tuple, ca)))}", flush=True)
            if not (torch.equal(cc, pc) and lists_equal == ANALYSIS_B):
                raise SystemExit(f"chip_smoke: solve_analysis differs on {name}[{bi}]")


def phase6(dev, card):
    """Returns the fully constrained fixtures (6a) and the card's
    synchronous ``time_resolves`` per fixture in us (6b)."""
    times, results = [], []
    for part in (lambda: phase6a(dev), lambda: phase6b(dev, card),
                 lambda: phase6c(dev), lambda: phase6d(dev)):
        t0 = time.perf_counter()
        results.append(part())
        times.append(round(time.perf_counter() - t0, 1))
    print(f"phase6 ok: {sum(times):.1f} s (a, b, c, d: {times} s)", flush=True)
    return results[0], results[1]


def fixture_names():
    cases = os.path.join(HERE, "tests", "cases")
    return sorted(n for n in os.listdir(cases)
                  if os.path.exists(os.path.join(cases, n, "problem.md")))


def problem_tuple(p):
    """Everything a parser puts in a ``Problem``, for exact comparison."""
    return ([(i.op, tuple(i.labels), i.value,
              None if i.component is None else i.component.value,
              None if i.angle is None else (i.angle.val, i.angle.degrees))
             for i in p.instructions],
            p.inner_points, p.inner_circles, p.inner_arcs, p.inner_lines,
            [(g.point, g.x, g.y) for g in p.point_guesses],
            [(g.scalar, g.guess) for g in p.scalar_guesses])


def host_seconds(fn, reps=REPS):
    """(median host seconds of ``reps`` calls of ``fn``, its last result)."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        walls.append(time.perf_counter() - t0)
    return sorted(walls)[reps // 2], out


def phase7a(card):
    """The native parser and union-find: built with g++ from the checkout,
    equal to the Python paths, and timed against them."""
    import numpy as np

    from ezpz_tpu_torch import native
    from ezpz_tpu_torch.models import blocks
    from ezpz_tpu_torch.textual import parser

    if os.environ.get("EZPZ_NO_NATIVE"):
        raise SystemExit("chip_smoke: EZPZ_NO_NATIVE is set; phase 7 needs the native path")
    t0 = time.perf_counter()
    fastparse, fastdecomp = native.load_fastparse(), native.load_fastdecomp()
    built = time.perf_counter() - t0
    if fastparse is None or fastdecomp is None:
        raise SystemExit(f"chip_smoke: the native modules did not build or load "
                         f"(fastparse {fastparse}, fastdecomp {fastdecomp})")
    print(f"phase7a native: built and loaded in {built!r} s: "
          f"{os.path.relpath(fastparse.__file__, HERE)}, "
          f"{os.path.relpath(fastdecomp.__file__, HERE)}", flush=True)

    names = fixture_names()
    bad = [name for name in names
           if problem_tuple(parser._problem_from_native(fastparse.parse(fixture_text(name))))
           != problem_tuple(parser._parse_problem_py(fixture_text(name)))]
    print(f"phase7a parse: {len(names) - len(bad)}/{len(names)} fixtures give the same "
          f"Problem natively and in Python", flush=True)
    if bad:
        raise SystemExit(f"chip_smoke: the native parser differs from Python on {bad}")
    text = fixture_text("massive_parallel_system")
    nat, _ = host_seconds(lambda: parser.parse_problem(text))
    py, _ = host_seconds(lambda: parser._parse_problem_py(text))
    print(f"phase7a parse massive_parallel_system: native {nat * 1e3!r} ms, Python "
          f"{py * 1e3!r} ms ({py / nat!r}x; host clock, median of {REPS}); card: {card}",
          flush=True)

    cs = system_of(tiled_text("massive_parallel_system", TILES))
    n = len(cs.initial_guesses)
    deps = [r.constraint.dependent_variable_ids() for r in cs.constraints]
    nat, roots = host_seconds(lambda: blocks._component_roots_native(deps, n))
    py, py_roots = host_seconds(lambda: blocks._component_roots_python(deps, n))
    offsets = np.cumsum([0] + [len(ids) for ids in deps], dtype=np.int32)
    flat = np.array([v for ids in deps for v in ids], dtype=np.int32)
    sweep, _ = host_seconds(lambda: fastdecomp.components(n, offsets, flat))
    comps = blocks.connected_components([r.constraint for r in cs.constraints], n)
    print(f"phase7a union-find massive x{TILES} tiled ({n} variables, {len(deps)} "
          f"constraints, {len(comps)} components): native {nat * 1e3!r} ms (its C++ "
          f"sweep alone {sweep * 1e3!r} ms), Python {py * 1e3!r} ms ({py / nat!r}x; host "
          f"clock, median of {REPS}); roots equal {roots == py_roots}; card: {card}",
          flush=True)
    if roots != py_roots:
        raise SystemExit("chip_smoke: the native union-find differs from Python")


def answer_vector(out, labels):
    """A service answer's point coordinates in variable order."""
    import numpy as np

    return np.array([c for label in labels for c in out["points"][label]])


def same_answer(out, ref, full):
    """Equal flags, and points within X_TOL when fully constrained."""
    import numpy as np

    if (out["converged"], out["unsatisfied"]) != (ref["converged"], ref["unsatisfied"]):
        return False, float("nan")
    labels = list(ref["points"])
    dx = float(np.abs(answer_vector(out, labels) - answer_vector(ref, labels)).max(initial=0.0))
    return dx <= X_TOL or not full, dx


def phase7_corpus(svc, cpu, full, card):
    """Every fixture as one request, twice (cold, then warm), to the card's
    service and once to the CPU's f64 service. Returns the oversized
    topology's record."""
    from ezpz_tpu_torch.models.compiled import compile_system
    from ezpz_tpu_torch.ops import fused_fleet
    from ezpz_tpu_torch.ops.fleet_plan import kernel_admits

    admitted, refused, bad, oversized = [], [], [], None
    fused_fleet.LAUNCHES = 0
    for name in fixture_names():
        text = fixture_text(name)
        cs = system_of(text)
        x0 = guesses(cs)
        system = compile_system([r.constraint.set_from_initial_values(x0)
                                 for r in cs.constraints], len(x0))
        ok = kernel_admits(system)
        instances = sum(b.idx.shape[0] for b in system.blocks)
        before = fused_fleet.LAUNCHES
        t0 = time.perf_counter()
        cold = svc.solve_text(text, timeout=600)
        t1 = time.perf_counter()
        warm = svc.solve_text(text, timeout=600)
        t2 = time.perf_counter()
        launches = fused_fleet.LAUNCHES - before
        ref = cpu.solve_text(text, timeout=600)
        (same_cold, dx), (same_warm, dx_warm) = (same_answer(cold, ref, name in full),
                                                  same_answer(warm, ref, name in full))
        (admitted if ok else refused).append(name)
        print(f"phase7b corpus {name}: gate {'admits' if ok else 'refuses'} "
              f"({instances} instances), {launches} fused "
              f"launches for 2 requests; converged {cold['converged']} unsatisfied "
              f"{cold['unsatisfied']} (cpu f64 {ref['converged']} {ref['unsatisfied']}); "
              f"max |x_card - x_cpu| {dx!r} / {dx_warm!r}, fully constrained "
              f"{name in full}; cold {(t1 - t0) * 1e3!r} ms, warm {(t2 - t1) * 1e3!r} ms; "
              f"card: {card}", flush=True)
        if not (same_cold and same_warm and cold["precision"] == "mixed"
                and launches == (2 if ok else 0)):
            bad.append(name)
        if name == "massive_parallel_system":
            oversized = dict(ok=ok, instances=instances, launches=launches, answer=warm,
                             cold=t1 - t0, warm=t2 - t1)
    print(f"phase7b corpus: {fused_fleet.LAUNCHES} fused launches; admitted {admitted}; "
          f"refused {refused}", flush=True)
    if bad or fused_fleet.LAUNCHES != 2 * len(admitted):
        raise SystemExit(f"chip_smoke: the card's service disagrees with the CPU's or "
                         f"launched wrongly on {bad}")
    return oversized


def burst_texts(rng):
    """BURST copies of ``two_rectangles``, each point guess moved by
    N(0, BURST_SIGMA)."""
    base = fixture_text("two_rectangles")

    def text():
        def move(m):
            x = float(m.group(1)) + rng.normal(0, BURST_SIGMA)
            y = float(m.group(2)) + rng.normal(0, BURST_SIGMA)
            return f"roughly ({x!r}, {y!r})"
        return re.sub(r"roughly \(([^,]+),([^)]+)\)", move, base)
    return [text() for _ in range(BURST)]


def send_burst(svc, texts, precision):
    """``texts`` from CLIENTS threads, each sending its share one request
    after another: (answers, per-request seconds, wall seconds)."""
    import threading

    answers, lat, errors = [None] * len(texts), [0.0] * len(texts), []

    def client(c):
        for i in range(c, len(texts), CLIENTS):
            t0 = time.perf_counter()
            try:
                answers[i] = svc.solve_text(texts[i], timeout=600, precision=precision)
            except Exception as e:  # reported below; the phase fails on any
                errors.append(f"{i}: {e}")
            lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise SystemExit(f"chip_smoke: burst ({precision}) failed: {errors[:5]}")
    return answers, lat, wall


def phase7_burst(dev, card):
    """BURST ``two_rectangles`` requests from CLIENTS threads to one card
    service (window BURST_WINDOW_MS), mixed by default and then f64 per
    request, against ``BatchSolver(precision="f64")`` on the CPU; then the
    batch alone on the card (CUDA events) and the host's parse time."""
    import numpy as np
    import torch

    from ezpz_tpu_torch import serve
    from ezpz_tpu_torch.batch import BatchSolver
    from ezpz_tpu_torch.config import Config
    from ezpz_tpu_torch.models.compiled import compile_system
    from ezpz_tpu_torch.ops import coarse_fleet, fused_fleet
    from ezpz_tpu_torch.textual import parser

    texts = burst_texts(np.random.default_rng(7))
    systems = [p.to_constraint_system() for p in map(parser.parse_problem, texts)]
    labels = systems[0].inner_points
    x0 = np.stack([guesses(cs) for cs in systems])
    system = compile_system([r.constraint for r in systems[0].constraints], x0.shape[1])
    t0 = time.perf_counter()
    ref = BatchSolver(system, Config(), device="cpu").solve(x0)
    print(f"phase7b burst reference: BatchSolver f64 on the CPU, {BURST} lanes, "
          f"{time.perf_counter() - t0!r} s, all converged {bool(ref.converged.all())}",
          flush=True)
    ref_x = ref.x.numpy()

    svc = serve.SolverService(batch_window_ms=BURST_WINDOW_MS, max_batch=BURST)
    try:
        for precision in (None, "f64"):
            t0 = time.perf_counter()
            svc.solve_text(texts[0], timeout=600, precision=precision)
            cold = time.perf_counter() - t0
            batches = svc.stats["batches"]
            fused_fleet.LAUNCHES = coarse_fleet.LAUNCHES = 0
            answers, lat, wall = send_burst(svc, texts, precision)
            launches, coarse = fused_fleet.LAUNCHES, coarse_fleet.LAUNCHES
            batches = svc.stats["batches"] - batches
            label = precision or svc.precision
            dx = max(float(np.abs(answer_vector(a, labels) - x).max())
                     for a, x in zip(answers, ref_x))
            good = all(a["converged"] and not a["unsatisfied"] and a["precision"] == label
                       for a in answers)
            lat.sort()
            print(f"phase7b burst {label}: {BURST} requests from {CLIENTS} clients in "
                  f"{wall!r} s: {BURST / wall!r} requests/s, latency p50 "
                  f"{lat[len(lat) // 2] * 1e3!r} ms p99 {lat[int(0.99 * len(lat))] * 1e3!r} ms, "
                  f"{batches} batches ({BURST / batches!r} requests each), fused launches "
                  f"{launches}, coarse {coarse}; all converged and satisfied {good}, max "
                  f"|x - x_cpu_f64| {dx!r}; first request (solver build) {cold * 1e3!r} ms; "
                  f"card: {card}", flush=True)
            want = batches if label == "mixed" else 0
            if not (good and dx <= X_TOL and batches <= BURST // 8 and launches == want
                    and coarse == 0):
                raise SystemExit(f"chip_smoke: the {label} burst failed")
    finally:
        svc.shutdown()

    # The same lanes as one batch, alone: where the device time goes.
    xb = torch.as_tensor(x0, device=dev)
    pars = tuple(torch.as_tensor(b.par, device=dev).expand(BURST, -1, -1).contiguous()
                 for b in system.blocks)
    for precision, fused in (("mixed", True), ("f64", False)):
        solver = BatchSolver(system, Config(), batch_params=True, precision=precision,
                             pallas_fused=fused, device=dev)
        wall, (ms,), _walls = timed(around(lambda k: solver.solve(
            xb + k * 1e-9, pars, finish_stragglers=solver.pallas_fused)))
        print(f"phase7b burst lanes alone: BatchSolver.solve {precision}"
              f"{' fused' if fused else ''} on {BURST} lanes {ms!r} ms CUDA events, "
              f"{wall * 1e3!r} ms host (median of {REPS}); card: {card}", flush=True)
    nat, _ = host_seconds(lambda: [parser.parse_problem(t) for t in texts], reps=1)
    py, _ = host_seconds(lambda: [parser._parse_problem_py(t) for t in texts], reps=1)
    print(f"phase7b burst parse of the {BURST} texts on the host: native {nat * 1e3!r} ms, "
          f"Python {py * 1e3!r} ms; card: {card}", flush=True)


def http_call(port, method, path, body=None, headers=None):
    """(status, JSON body or None) from the service on 127.0.0.1."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    return resp.status, (json.loads(data) if data else None)


def phase7_http(svc, cpu):
    """The card's service behind ``serve.make_handler``: routes, the
    X-Precision header and the error body."""
    import threading
    from http.server import ThreadingHTTPServer

    from ezpz_tpu_torch import serve

    text = fixture_text("tiny")
    ref = cpu.solve_text(text, timeout=600)
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(svc))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        mixed = http_call(port, "POST", "/solve", text.encode())
        f64 = http_call(port, "POST", "/solve", text.encode(), {"X-Precision": "f64"})
        health = http_call(port, "GET", "/healthz")
        missing = [http_call(port, m, "/nope", b"x" if m == "POST" else None)[0]
                   for m in ("GET", "POST")]
        bad = http_call(port, "POST", "/solve", b"this is not a problem")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    checks = {
        "mixed": mixed[0] == 200 and mixed[1]["precision"] == "mixed"
        and same_answer(mixed[1], ref, True)[0],
        "f64": f64[0] == 200 and f64[1]["precision"] == "f64"
        and f64[1]["iterations_comparable"] is True
        and f64[1]["iterations"] == ref["iterations"] and same_answer(f64[1], ref, True)[0],
        "healthz": health[0] == 200 and health[1]["ok"] is True
        and health[1]["requests"] >= 2,
        "404": missing == [404, 404],
        "400": bad[0] == 400 and "error" in bad[1],
    }
    print(f"phase7c http: {json.dumps(checks)}; healthz {json.dumps(health[1])}", flush=True)
    if not all(checks.values()):
        raise SystemExit("chip_smoke: the HTTP front end failed")


def phase7_embed(card):
    """The embedding probes on the card, against the CPU."""
    import numpy as np

    from ezpz_tpu_torch import embed

    vals, cpu_vals = embed.benchmark(), embed.benchmark(device="cpu")
    dx = float(np.abs(np.subtract(vals, cpu_vals)).max())
    card_s, _ = host_seconds(lambda: [embed.benchmark() for _ in range(EMBED_CALLS)], reps=1)
    cpu_s, _ = host_seconds(lambda: [embed.benchmark(device="cpu")
                                     for _ in range(EMBED_CALLS)], reps=1)
    checks = dict(hello=embed.hello() == 33, test_linalg=embed.test_linalg() == 1.0,
                  benchmark=len(vals) == 14 and dx <= 1e-9)
    print(f"phase7d embed: {json.dumps(checks)}, max |card - cpu| {dx!r}; benchmark() "
          f"{card_s / EMBED_CALLS * 1e3!r} ms per call on the card, "
          f"{cpu_s / EMBED_CALLS * 1e3!r} ms on the CPU (mean of {EMBED_CALLS}); "
          f"card: {card}", flush=True)
    if not all(checks.values()):
        raise SystemExit("chip_smoke: the embed probes failed on the card")


def phase7(dev, card, full, api_us):
    """The serving path on the card: native front end (a), the service's
    corpus, burst, oversized topology and sequential rate (b), HTTP (c),
    embed (d)."""
    from ezpz_tpu_torch import serve

    svc = serve.SolverService()
    cpu = serve.SolverService(device="cpu", precision="f64")
    try:
        if not (svc.device.type == "cuda" and svc.precision == "mixed" and svc.pallas_fused):
            raise SystemExit(f"chip_smoke: SolverService() resolved to {svc.device}, "
                             f"{svc.precision}, fused {svc.pallas_fused}")
        times = []
        for part in (lambda: phase7a(card),
                     lambda: phase7_oversized(phase7_corpus(svc, cpu, full, card), card),
                     lambda: phase7_burst(dev, card),
                     lambda: phase7_sequential(card, api_us),
                     lambda: phase7_http(svc, cpu),
                     lambda: phase7_embed(card)):
            t0 = time.perf_counter()
            part()
            times.append(round(time.perf_counter() - t0, 1))
    finally:
        svc.shutdown()
        cpu.shutdown()
    print(f"phase7 ok: {sum(times):.1f} s (native, corpus, burst, sequential, http, "
          f"embed: {times} s)", flush=True)


def phase7_oversized(big, card):
    """The corpus's one topology over the kernel gate: answered on the
    batched mixed path, no launch."""
    a = big["answer"]
    print(f"phase7b oversized massive_parallel_system: {big['instances']} instances, "
          f"gate admits {big['ok']}, fused launches {big['launches']}; converged "
          f"{a['converged']}, unsatisfied {len(a['unsatisfied'])}; cold "
          f"{big['cold'] * 1e3!r} ms, warm {big['warm'] * 1e3!r} ms; card: {card}",
          flush=True)
    if big["ok"] or big["launches"] or not a["converged"] or a["unsatisfied"]:
        raise SystemExit("chip_smoke: the oversized request failed")


def phase7_sequential(card, api_us):
    """``serve.benchmark`` on the card: one request at a time, each a batch
    of one through the fused kernel."""
    from ezpz_tpu_torch import serve
    from ezpz_tpu_torch.ops import fused_fleet

    fused_fleet.LAUNCHES = 0
    rate = serve.benchmark(n=SEQUENTIAL_N)
    print(f"phase7b sequential: serve.benchmark(n={SEQUENTIAL_N}) {rate!r} solves/s "
          f"({1e3 / rate!r} ms per request), fused launches {fused_fleet.LAUNCHES}; the "
          f"API's synchronous time_resolves of two_rectangles (phase 6b) "
          f"{api_us['two_rectangles'] / 1e3!r} ms; card: {card}", flush=True)
    if fused_fleet.LAUNCHES != SEQUENTIAL_N + 1:
        raise SystemExit("chip_smoke: serve.benchmark did not launch once per request")


def kernel_ms(solvers, entry, plain=False):
    """Median ms per main-path solve of one kernel (or its plain version)
    alone: CUDA events around INNER solves of every bucket, on inputs made
    before the first event (fresh per solve), so the host's enqueue gaps
    between launches are amortized."""
    from ezpz_tpu_torch.ops import coarse_fleet, fused_fleet

    if entry == "fused":
        run = fused_fleet.fused_fleet_reference if plain else fused_fleet.fused_fleet_solve
    else:
        run = coarse_fleet.coarse_fleet_reference if plain else coarse_fleet.coarse_fleet_solve

    def body(k, ev):
        inputs = [(s, xb + (INNER * k + j) * 1e-9, pb) for j in range(INNER)
                  for s, xb, pb in solvers]
        ev[0].record()
        for s, x, pb in inputs:
            run(s.plan, x, pb, **(s.settings() if entry == "fused" else s.coarse_settings()))
        ev[1].record()
    return timed(body)[1][0] / INNER


def occupancy_lines():
    """Resident threads per SM of every instantiation (the big kernel
    with the shared memory of the gate's 256 instances)."""
    from ezpz_tpu_torch.ops import _build

    lib = _build.load_library()
    out = []
    for entry in ("fused", "coarse"):
        for shape in (*_build.SMALL_SHAPES, None):
            threads = _build.resident_threads(lib, entry, shape, n_inst=256)
            name = (f"{entry}_small_kernel<{shape[0]},{shape[1]}>" if shape
                    else f"{entry}_big_kernel (256 instances)")
            out.append(f"{name}: {threads} resident threads per SM")
    return out


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
    for line in occupancy_lines():
        print("phase2 occupancy " + line, flush=True)

    phase3(dev)
    phase3b(dev)
    phase3c(dev, card)
    fused = phase4(dev, card)
    coarse = phase5(dev, card)
    full, api_us = phase6(dev, card)
    phase7(dev, card, full, api_us)
    kernels = []
    for name, rec, line in (("fused_fleet", fused, 898), ("coarse_fleet", coarse, 598)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"ezpz_tpu_torch/csrc/{name}.cu",
            "replaces": f"ezpz_tpu/ops/pallas_fleet.py:{line}",
            "launches": rec["launches"],
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": None,
        })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
