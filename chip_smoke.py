#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ezpz_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. the card (``nvidia-smi`` name and power limit) and the CUDA runtime;
   no GPU, no run;
2. build the kernels (``csrc/fused_fleet.cu``, ``csrc/coarse_fleet.cu``,
   ``csrc/banded_spd.cu``, ``csrc/banded_dynamic.cu``,
   ``csrc/banded_lanes.cu``, ``csrc/lm_jacobian.cu``) with nvcc, one compiler per source, all
   started together, and print
   each instantiation's registers, stack frame and spills, and the fleet
   kernels' resident threads per SM;
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
   kernel, then the batched f64-residual refinement, which factors the
   four topologies past 24 variables in their band: ``batch._pick_spd``)
   against the same path with the plain coarse version, as in phase 3;
3c. each kernel alone (CUDA events, median of 5) on the topologies above
   the main path's shapes that the big-topology kernel takes (``square``
   and ``chamfer_square`` of the corpus, ``rect_chain(8)``, ``chain(40)``)
   and on two that ``<8,8>`` takes (``parallelogram``, ``arc_length``), at
   MIDSIZE_B seeded perturbations each (``MIDSIZE``; ``phase3c`` also runs
   alone, on any checkout whose package has the same wrappers);
3d. the band tier of ``BatchSolver`` (``batch._pick_spd``): ``rect_chain(64)``
   (386 variables and instances, bw 7: the one-thread-per-lane kernel's
   route) and ``rect_grid(8,8)`` (162 variables, 290 instances, bw 19: the
   warp kernel's), both past the fused kernel's gate, at BAND_B = 8192
   seeded perturbations (sigma 1e-3) with per-sketch parameters through
   ``BatchSolver(precision="mixed", pallas_fused=True,
   batch_params=True).solve``: counts from zero, the bench gate, the
   route's banded kernel launched, the Jacobian kernel once an LM trip
   (``lm.band_steps``) and no fleet kernel; the damped solve in one launch
   a trip on the lane kernel's route (``lm.band_damped``; 3 lane launches
   a ``rect_chain(64)`` solve, 6 in two calls a trip on the warp route),
   and the lanes the lane kernel's in-kernel retry re-solved (read in one
   more solve, outside the counts); the dense witness
   (``solve_lm_mixed(..., spd=spd_solve)``) on the same lanes: converged,
   satisfied and degenerate equal lane for lane, iterations equal on at
   least 99.9% of lanes, x within 1e-6 where both converged; both solves
   timed (CUDA events, median of 5, fresh inputs) with their split between
   assembly (``normal_equations``) and factor, LM trips and banded
   launches per solve; the kernel alone on the run's first band in the
   main path's mode, in f32 and f64: at the chain the damped one launch
   (``damped_kernel``: bit-equal to ``solver._rescued`` over the plain
   version, with lambda -1, NaN and -2 max|diagonal| on four lanes so that
   the in-kernel retry runs; timed beside the undamped launch on the band
   damped beforehand), at the grid the warp kernel (``phase8_kernel``:
   bit-equal to the plain version); the dense library on the same
   matrices, the bound;
3j. the LM step's Jacobian kernel (``ops/lm_jacobian.py``, one launch a
   ``normal_equations`` call on the card) against its plain version, to
   the bit (rows, product columns, degenerate flags), in float32 and
   float64: each of the 23 kinds at LMJ_KINDS_B lanes (every fourth
   degenerate) and ``rect_chain(64)`` at the benchmark's LMJ_B lanes with
   per-lane parameters, each with and without an rhs; then the kernel
   alone at the chain (CUDA events around 10 launches, median of 5, fresh
   x) beside its byte bound (``lm_jacobian_bytes``) and the plain
   version's time (its launches on the main path are phase 3d's);
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
   (d) the embed probes on the card against the CPU, timed;
8. the coupled path, ``bench.py``'s second headline (``phase8``): the
   600-line ``coupled`` chain (2,400 variables, not block-diagonal) through
   ``textual.Problem`` and ``parallel.BlockSchurSolver(n_parts=120,
   boundary_solver="banded", precision="mixed")``, 1024 copies (guesses
   moved by seeded N(0, 1e-3)); structure P, m, kb, n_b, bw = 120, 16, 12,
   952, 11. Counts from zero: the banded kernel launched (the
   one-thread-per-lane kernel, ``csrc/banded_lanes.cu``, whose route takes
   bw 11 at every batch); every lane converged and satisfied, the f64 residual
   recomputed by ``residual_and_flags`` <= 1e-8. Held against the same
   solve with the warp kernel's route forced (``csrc/banded_spd.cu``,
   whose route the lane kernel takes at bw 11: bit for bit), the same
   solve with the plain banded version on the card (flags and iterations
   equal, x within 1e-6), a second identical run (bit for bit), the dense
   and CG boundaries at 64 copies (flags equal, iterations equal for
   dense) and ``precision="f64"`` on the CPU at 4 copies (flags equal);
   across boundaries and precisions x within 600 x 1e-8 (one residual
   tolerance per link of the chain, ``COUPLED_X_TOL``). Timed: solves/s
   (5 reps, fresh inputs), the ms per LM trip by part (Jacobian pass,
   interior solves, boundary solve, rest of the step, loop and sync),
   ``solve``'s batch-1 latency, launches per
   ``solve_batch`` under ``torch.profiler``, peak memory, and the kernel
   alone on the first boundary solve's band against its plain version and
   the dense ``cholesky_ex`` + ``cholesky_solve`` of the same matrix, in
   f32 and f64, the warp kernel forced beside it;
8l. the one-thread-per-lane route on the main path (``phase8_lanes``):
   phase 8's chain at 8192 copies through
   ``BlockSchurSolver(boundary_solver="auto")`` (banded, mixed), counts
   from zero, phase 8's gate, the ``"lanes"`` route launched; the lane
   kernel alone on the run's first band (B = 8192, n = 952, bw = 11):
   bit-equal to the plain version in f32 and f64, backward error, the
   warp kernel forced on the same band (bit-equal, timed beside it: the
   crossover re-measured), the bound, and the dense library in chunks of
   1024 lanes (8192 x 952^2 in f64 does not fit), their times summed;
8w. a boundary band wider than 32 (``phase8w``): the same chain and
   copies with every 4th of the 120 parts' variables moved to the part 3
   to its right (``moved_parts``), so that ``boundary_solver="auto"``
   resolves to banded at n_b = 952, bw = 35, past the warp and lane
   kernels' 32: mixed and f64, counts from zero, phase 8's gate, the
   dynamic-width kernel's route launched, mixed and f64 within
   ``COUPLED_X_TOL``; a world-1 ``ShardedBlockSchurSolver`` (B = 1) on the
   same parts, converged and satisfied, its own launches; the kernel alone
   on the mixed run's first band and the sharded run's (``phase8_kernel``:
   bit-equal to the plain version in f32 and f64, backward error, the
   library, the bound), the general-width kernel forced on the same band,
   bit-equal and timed beside it; then every 8th part moved 7 (bw = 67) in
   mixed through the dynamic-width kernel with the same gate, the same run
   with the general-width kernel forced, and the dynamic-width kernel alone
   on the first run's band (``phase8_kernel`` again), the general-width
   kernel forced on that band, bit-equal and timed beside it; last every
   4th part moved 2 (bw = 27, past the lane kernel's 16) in mixed through
   the warp kernel's own route with the same gate, and the warp kernel
   alone on that run's first band in f32 (bit-equal to the plain version,
   the library, the bound);
9. the single-device remainder (``phase9``):
   (a) ``parallel.FleetSolver`` over every visible card on the main path
   (the massive fixture x 8192, both buckets, mixed + fused): counts from
   zero, one fused launch per bucket per card, the bench gate, every shard
   bit-equal to ``BatchSolver`` on the same lanes and card, timed against
   it (CUDA events and host clock, 5 reps); and ``precision="f64"`` on the
   ``<2,2>`` bucket's first 8192 lanes, bit-equal to ``BatchSolver``;
   (b) ``solver.solve_lm_cg`` in f64 on 1024 copies of the 200-line
   ``coupled`` chain (800 variables, guesses moved by seeded N(0, 1e-3)):
   every lane converged, max|r| <= 1e-8 recomputed in f64; flags and
   iterations equal to dense ``solve_lm`` on the card, x within 200 x 1e-8
   (``CG_X_TOL``); LM trips, CG trips, host syncs, peak memory against the
   dense solve's, ms per solve of both (5 reps, fresh inputs), one profiled
   solve; and one copy of the 600-line chain, which must stop unconverged
   at the 35-iteration budget as the JAX package's does;
   (c) ``solver.solve_gauss_newton`` on the same 1024 copies: every lane
   converged in f64; flags and iterations equal to the CPU's on 4 copies;
   (d) the five ``residual_viz`` fields on the card, pixel-equal to the
   CPU's (or scoring >= 0.99 by ``compare_images``);
   (e) the three examples (``ezpz_tpu_torch.examples``) on the card, their
   lines checked;
10. the collective slice (``phase10``), the sharded solvers over
   ``torch.distributed`` ranks (spawned; ``parallel.dist``):
   (a) the 100,000-variable coupled chain of SHARDED_r03.json (25,000
   lines of the ``coupled`` fixture; 2,500 parts, n_b = 19,992, bw = 11)
   through ``ShardedBlockSchurSolver(boundary_solver="banded",
   precision="mixed")`` under an NCCL group of every visible card (world 1
   on one card), with a 60-trip LM budget (the trip count is decided by
   f32 rounding here; the max|r| at the default 35 trips is printed):
   converged, every constraint satisfied, the f64 residual
   recomputed <= 1e-8, every rank's outcome rank 0's and every solve's the
   first's (bit for bit); counts from zero in each rank: the banded kernel
   launched; iterations, ms per solve (host clock, median of 3 after one
   warm solve), collectives, bytes and host syncs per solve, banded calls
   per solve, peak memory, one profiled solve; the same chain in f64 (exact
   steps), and, as the witness of what rounding costs in trips, in mixed
   with the dense boundary (the library's factorization) under the same
   budget; then the kernel alone on the first boundary solve's band (B =
   1) of the mixed run in f32 and of the f64 run in f64: held against its
   plain version on the card at full size (within 1e-6; built to agree
   bit for bit), backward stable (``band_backward_error`` <= 1e-6 in f32,
   1e-13 in f64), and timed against the dense ``cholesky_ex`` +
   ``cholesky_solve``; and why f32 solves of that band part (whether
   the f32 band has a Cholesky factor in f64; PyTorch's CPU sqrt is not
   correctly rounded, so the plain version on the host CPU parts from the
   kernel);
   (b) the 100,004-variable hub assembly (``fixtures.coupled_hub(25_001,
   10)``, the CG boundary): the same checks, with its CG trips;
   (c) 4 gloo ranks on cuda:0 (the only multi-rank check one card allows):
   ``ShardedSchurSolver`` (dense, f64) on a 1,024-point horizontal chain
   and (a)'s solver on the 2,500-line chain, against the same solvers as
   a world of one on the card: flags and iterations equal, x within 1e-6;
   (d) ``dryrun.dryrun_multichip`` over every visible card, and
   ``python -m ezpz_tpu_torch.launch --demo schur`` and ``--demo fleet``
   as one process each.

The line before the last is a JSON record per kernel: launches in its main
path's run, max
|x_kernel - x_plain| at the main path's shapes, ms per main-path solve (the
banded kernel: per call, at phase 8's operating point) for the kernel and
for its plain version (CUDA events, median of 5; the banded plain version
once, host clock), and the least time the card could take (``bound_ms``: the
larger of the bytes each kernel must move over 3.35 TB/s and a lower
bound of its operations over 67 TFLOP/s in f32 and 34 TFLOP/s in f64,
counted from this run's inputs and iteration counts). No single PyTorch
call computes an LM fleet solve, so the fleet kernels' ``library_ms`` is
null; the banded kernels' is the dense Cholesky factorization and solve
of the same matrix. The banded kernels are records of their own:
``banded_spd`` (the warp kernel at phase 8w's bw = 27 band; that run's
launches and phase 3d's ``rect_grid(8,8)`` run's), ``banded_spd_lanes``
(the one-thread-per-lane kernel at phase 8l's band; the launches of phase
3d's ``rect_chain(64)`` run and phase 8's, 8l's and 10a's runs), ``banded_spd_wide`` (the dynamic-width kernel at
phase 8w's bw = 35 band; launches of its mixed, f64 and sharded runs),
``banded_spd_dynamic`` (the dynamic-width kernel at the bw = 67 run's
band; its launches) and ``banded_spd_general`` (the general-width kernel
forced on that band, bit-equal to the plain version; the launches of the
bw = 67 run with the route forced). The last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
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
    registers, static shared memory, stack frame and spills."""
    if not os.path.exists(log_path):
        return []
    out, name = [], None
    for line in open(log_path):
        m = re.search(r"Compiling entry function '.*?(fused|coarse)_(small|big)_kernel"
                      r"(?:ILi(\d+)ELi(\d+)E)?", line)
        b = re.search(r"Compiling entry function '.*?banded_spd_(warp|lanes|dynamic)_kernel"
                      r"I([fd])Li(\d+)E",
                      line)
        g = re.search(r"Compiling entry function '.*?banded_spd_general_kernelI([fd])E", line)
        j = re.search(r"Compiling entry function '.*?lm_jacobian_kernelI([fd])E", line)
        if m:
            shape = f"<{m.group(3)},{m.group(4)}>" if m.group(3) else ""
            name = f"{m.group(1)}_{m.group(2)}_kernel{shape}"
        elif b:
            name = (f"banded_spd_{b.group(1)}_kernel<"
                    f"{'float' if b.group(2) == 'f' else 'double'},{b.group(3)}>")
        elif g:
            name = f"banded_spd_general_kernel<{'float' if g.group(1) == 'f' else 'double'}>"
        elif j:
            name = f"lm_jacobian_kernel<{'float' if j.group(1) == 'f' else 'double'}>"
        elif name and "stack frame" in line:
            frame = line.strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {regs} registers, {smem.group(1) if smem else 0} bytes smem, "
                       f"{frame}")
            name = None
    return out


def guesses(cs):
    import numpy as np

    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val
    return x0


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
    from ezpz_tpu_torch.fixtures import rect_chain

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


# Phase 3d: the band tier of ``BatchSolver`` (``batch._pick_spd``) on
# the card. Both topologies are past the fused kernel's gate, so the fused
# mode takes the batched mixed path, whose damped normal equations the
# topology's band factors: (label, n_vars, bw, the banded route at
# BAND_B lanes).
BAND_TIER = (("rect_chain(64)", 386, 7, "lanes"), ("rect_grid(8,8)", 162, 19, "warp"))
BAND_B = 8192


def band_topology(label):
    from ezpz_tpu_torch import fixtures

    return fixtures.rect_chain(64) if label == "rect_chain(64)" else fixtures.rect_grid(8, 8)


def dense_witness(solver, x0s, pars, spd=None):
    """The same lanes through ``solve_lm_mixed`` with the dense factor
    (``spd_solve``, the port's route for these topologies before the band
    tier; ``spd`` in its place), with its satisfaction: a
    ``BatchResult``."""
    from ezpz_tpu_torch.batch import BatchResult
    from ezpz_tpu_torch.ops.linalg import spd_solve
    from ezpz_tpu_torch.solver import solve_lm_mixed

    c = solver.config
    res = solve_lm_mixed(solver.system, solver.system32, x0s, c.max_iterations,
                         c.residual_tolerance, c.step_tolerance, c.initial_lambda,
                         pars64=pars, pars32=tuple(p.float() for p in pars),
                         spd=spd or spd_solve)
    return BatchResult(x=res.x, iterations=res.iterations, converged=res.converged,
                       satisfied=solver.system.satisfaction(res.x, res.residual, pars),
                       degenerate=res.deg)


def band_split(run):
    """One ``run(spd_wrapper)`` with CUDA events around every normal-
    equation assembly (``CompiledSystem.normal_equations``) and every
    factorization (the solve the wrapper is handed: the dense route's
    ``spd``, the band tier's ``banded_spd.banded_spd_cuda``): (ms of the
    whole run, ms in assembly, ms in the factor, LM trips)."""
    import torch

    from ezpz_tpu_torch.models import compiled

    marks = {"assembly": [], "factor": []}

    def timed_call(key, fn):
        def wrapper(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            marks[key].append(ev)
            return out
        return wrapper

    saved = compiled.CompiledSystem.normal_equations
    compiled.CompiledSystem.normal_equations = timed_call("assembly", saved)
    try:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        run(lambda spd: timed_call("factor", spd))
        ev[1].record()
        torch.cuda.synchronize()
    finally:
        compiled.CompiledSystem.normal_equations = saved
    summed = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in marks.items()}
    return ev[0].elapsed_time(ev[1]), summed["assembly"], summed["factor"], len(marks["assembly"])


def phase3d(dev, card):
    """The band tier on the card at full size: each topology of BAND_TIER
    at BAND_B seeded perturbations (sigma 1e-3) with per-sketch parameters
    through ``BatchSolver(precision="mixed", pallas_fused=True,
    batch_params=True)``: counts from zero, the bench gate, the route's
    banded kernel launched, the Jacobian kernel (``ops/lm_jacobian.py``)
    once an LM trip (one ``normal_equations`` call, counted by
    ``lm.band_steps``) and no fleet kernel; on the lane kernel's route
    one damped launch a trip (``lm.band_damped``), elsewhere two calls a
    trip; the lanes the in-kernel retry re-solved; the dense witness on the
    same lanes (flags equal, iterations on ITER_EQUAL_MIN of the lanes, x
    within X_TOL); both timed (CUDA events, median of REPS, fresh inputs)
    with their split between assembly and factor; the kernel alone on the
    run's first band in the main path's mode: the damped one launch on the
    lane route (``damped_kernel``: against ``_rescued`` over the plain
    version, with the retry made to run), the undamped kernel on the
    composition's damped band elsewhere (``phase8_kernel``). Returns the
    main-path runs' launches by banded route, and under ``"lm_jacobian"``
    the Jacobian kernel's."""
    import numpy as np
    import torch

    from ezpz_tpu_torch import tracing
    from ezpz_tpu_torch.batch import BatchSolver
    from ezpz_tpu_torch.config import Config
    from ezpz_tpu_torch.models.compiled import compile_system
    from ezpz_tpu_torch.ops import banded, banded_spd, coarse_fleet, fused_fleet, lm_jacobian
    from ezpz_tpu_torch.ops.linalg import spd_solve

    t_start = time.perf_counter()
    launches = dict.fromkeys(banded_spd.LAUNCHES, 0)
    launches["lm_jacobian"] = 0
    for seed, (label, n_want, bw_want, route_want) in enumerate(BAND_TIER):
        t_topology = time.perf_counter()
        cons, x0 = band_topology(label)
        system = compile_system(cons, n_vars=len(x0))
        solver = BatchSolver(system, Config(), batch_params=True, precision="mixed",
                             pallas_fused=True, device=dev)
        plan = banded.plan_band(system)
        bw = None if plan is None else plan[1]
        n_inst = sum(int(b.idx.shape[0]) for b in system.blocks)
        route_at = banded_spd.route_for(BAND_B, bw or 0, 4)
        order = "RCM" if plan and plan[0] is not None else "identity"
        print(f"phase3d {label}: {system.n_vars} variables, {n_inst} instances, kernel "
              f"gate {solver.kernel_ok}, band bw {bw} ({order} ordering), route at {BAND_B} "
              f"lanes: {route_at}", flush=True)
        if (system.n_vars, bw, route_at) != (n_want, bw_want, route_want) or solver.kernel_ok:
            raise SystemExit(f"chip_smoke: phase3d {label} is not the band tier's case")
        rng = np.random.default_rng(300 + seed)
        noise = rng.normal(0.0, 1e-3, (REPS + 1, BAND_B, len(x0)))
        xs = [torch.as_tensor(x0 + noise[k], device=dev) for k in range(REPS + 1)]
        pars = tuple(torch.as_tensor(np.tile(b.par, (BAND_B, 1, 1)), device=dev)
                     for b in system.blocks)
        solver.solve(xs[0][:2], tuple(p[:2] for p in pars))  # warm-up
        dense_witness(solver, xs[0][:2], tuple(p[:2] for p in pars))

        # The main-path run: counts from zero.
        banded_spd.LAUNCHES = dict.fromkeys(banded_spd.LAUNCHES, 0)
        fused_fleet.LAUNCHES = coarse_fleet.LAUNCHES = lm_jacobian.LAUNCHES = 0
        counted = tracing.counts()
        torch.cuda.reset_peak_memory_stats()
        with first_kernel_band(banded_spd) as captured:
            out = solver.solve(xs[0], pars)
            torch.cuda.synchronize()
        routes = dict(banded_spd.LAUNCHES)
        fleet = fused_fleet.LAUNCHES + coarse_fleet.LAUNCHES
        steps, damped = (tracing.counts().get(k, 0) - counted.get(k, 0)
                         for k in ("lm.band_steps", "lm.band_damped"))
        jacobian = lm_jacobian.LAUNCHES
        peak = torch.cuda.max_memory_allocated()
        gate(f"phase3d {label} band tier x{BAND_B}", [(solver, xs[0], pars)], [out])
        print(f"phase3d {label}: banded launches by route {routes}, Jacobian kernel "
              f"launches {jacobian} over {steps} LM trips, fleet kernel launches {fleet}, "
              f"iterations {int(out.iterations.min())}-{int(out.iterations.max())}, "
              f"peak device memory {peak!r} bytes", flush=True)
        others = sum(v for k, v in routes.items() if k != route_want)
        if routes[route_want] == 0 or others or fleet:
            raise SystemExit(f"chip_smoke: phase3d {label} did not run on the banded "
                             f"kernel's {route_want} route alone")
        if steps == 0 or jacobian != steps:
            raise SystemExit(f"chip_smoke: phase3d {label} launched the Jacobian kernel "
                             f"{jacobian} times in {steps} LM trips, not once a trip")
        # The damped solve: one launch a trip on the lane kernel's route,
        # two calls a trip (raw and floored lambda) on any other.
        one = route_want == "lanes"
        calls, resolved = retry_lanes(banded_spd, lambda: solver.solve(xs[0], pars))
        print(f"phase3d {label}: lane-kernel launches per solve {routes['lanes']}, "
              f"lm.band_damped {damped}, lanes the in-kernel retry re-solved {resolved} "
              f"(in {calls} one-launch damped solves of {BAND_B} lanes)", flush=True)
        if damped != (steps if one else 0) or routes[route_want] != steps * (1 if one else 2):
            raise SystemExit(f"chip_smoke: phase3d {label} made {routes[route_want]} "
                             f"{route_want} launches and {damped} one-launch damped solves "
                             f"in {steps} LM trips")
        launches[route_want] += routes[route_want]
        launches["lm_jacobian"] += jacobian

        # The dense witness on the same lanes.
        torch.cuda.reset_peak_memory_stats()
        dense = dense_witness(solver, xs[0], pars)
        dense_peak = torch.cuda.max_memory_allocated()
        check(f"phase3d {label} band tier against the dense witness x{BAND_B} (peak device "
              f"memory of the witness {dense_peak!r} bytes)",
              compare(as_tuple(out), as_tuple(dense)))

        # Timing: whole solves on fresh inputs, then one split of each.
        _wall, band_ms, band_walls = timed(around(lambda k: solver.solve(xs[k + 1], pars)))
        _wall, dense_ms, dense_walls = timed(
            around(lambda k: dense_witness(solver, xs[k + 1], pars)))

        def band_run(wrap):
            # The band tier factors through ``banded_spd.banded_spd_cuda``.
            saved = banded_spd.banded_spd_cuda
            banded_spd.banded_spd_cuda = wrap(saved)
            try:
                solver.solve(xs[1], pars)
            finally:
                banded_spd.banded_spd_cuda = saved

        for name, run, ms, walls in (
                ("band tier", band_run, band_ms[0], band_walls),
                ("dense witness", lambda wrap: dense_witness(solver, xs[1], pars,
                                                             wrap(spd_solve)),
                 dense_ms[0], dense_walls)):
            total, assembly, factor, trips = band_split(run)
            print(f"phase3d {label} {name} x{BAND_B}: {ms!r} ms per solve (CUDA events, "
                  f"median of {REPS}, fresh inputs; host reps "
                  f"{[round(w * 1e3, 3) for w in walls]} ms), {BAND_B * 1e3 / ms!r} solves/s; "
                  f"split of one solve ({total!r} ms, {trips} LM trips): assembly "
                  f"{assembly!r} ms, factor {factor!r} ms, rest {total - assembly - factor!r} "
                  f"ms; card: {card}", flush=True)
        print(f"phase3d {label}: {sum(routes.values())} banded launches per solve "
              f"({route_want} route), band tier {band_ms[0]!r} ms against the dense "
              f"witness's {dense_ms[0]!r} ms", flush=True)
        del out, dense, xs
        torch.cuda.empty_cache()
        band, rhs, lam = captured[0]
        if one:
            damped_kernel(band, rhs, lam, card, f"phase3d {label}")
        else:
            phase8_kernel(band, rhs, card, label=f"phase3d {label}")
        print(f"phase3d {label} ok: {time.perf_counter() - t_topology:.1f} s", flush=True)
    print(f"phase3d ok: {time.perf_counter() - t_start:.1f} s", flush=True)
    return launches


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


LMJ_B = 24576
LMJ_KINDS_B = 4096
LMJ_INNER = 10


def lm_jacobian_bytes(t, B, n_vars):
    """The least bytes of one ``lm_jacobian`` launch of ``B`` lanes of
    ``n_vars`` variables on the tables ``t``: each lane's x and parameters
    read once, its rows read (the rhs) or written once, its product
    columns (with their zero column) written once, in the tables' dtype,
    and its flags (int32); the instance table (int32) and weights once."""
    size = t.weights.element_size()
    n_par = sum(p.numel() for p in t.par)
    per_lane = size * (n_vars + n_par + t.n_rows + t.n_jj + 1 + t.n_jr + 1) + 4 * t.n_deg
    return B * per_lane + t.inst.shape[0] * (4 * t.inst.shape[1] + size)


def phase3j(dev, card):
    """The LM step's Jacobian kernel (``ops/lm_jacobian.py``) on the card:
    against its plain version, to the bit (rows, product columns, flags),
    in float32 and float64, on each of the 23 kinds
    (``fixtures.every_kind``, 64 instances over 48 variables, LMJ_KINDS_B
    lanes, every fourth lane degenerate) and on ``rect_chain(64)`` at the
    benchmark's LMJ_B lanes with per-lane parameters, with and without an
    rhs; then the kernel alone at the chain (CUDA events around LMJ_INNER
    launches, median of REPS, with and without the rhs, and in float64)
    beside its byte bound and the plain version's time. Returns the
    kernel's record without its launches (phase 3d counts those on the
    main path); ``max_abs_err`` is the largest difference from the plain
    version over the chain's comparisons."""
    import numpy as np
    import torch

    from ezpz_tpu_torch import fixtures
    from ezpz_tpu_torch.models.compiled import compile_system
    from ezpz_tpu_torch.ops import lm_jacobian
    from ezpz_tpu_torch.ops.kernels import KERNELS

    t_start = time.perf_counter()
    err = 0.0

    def same(got, want, label):
        # Bit-equal, NaN where the plain version has NaN; returns the
        # largest |kernel - plain| over the finite values.
        worst = 0.0
        for g, w, what in zip(got, want, ("r", "jj", "jr", "deg")):
            both_nan = torch.isnan(g.double()) & torch.isnan(w.double())
            equal = g.shape == w.shape and bool(((g == w) | both_nan).all())
            if not equal:
                raise SystemExit(f"chip_smoke: phase3j {label}: the kernel's {what} is not "
                                 f"the plain version's")
            diff = (g.double() - w.double()).abs().masked_fill(both_nan, 0.0)
            worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        return worst

    rng = np.random.default_rng(3)
    for dtype in (torch.float32, torch.float64):
        for k, name in enumerate(sorted(KERNELS)):
            system = fixtures.every_kind(per_kind=64, n_vars=48, seed=k,
                                         kinds=[name]).astype(dtype)
            x = rng.uniform(-5.0, 5.0, (LMJ_KINDS_B, system.n_vars))
            x[::4] = x[::4, :1]
            x = torch.as_tensor(x, dtype=dtype, device=dev)
            pars = tuple(torch.as_tensor(
                b.par * rng.uniform(0.8, 1.25, (LMJ_KINDS_B,) + b.par.shape), dtype=dtype,
                device=dev) for b in system.blocks)
            rhs = torch.as_tensor(rng.normal(0.0, 1.0, (LMJ_KINDS_B, system.n_rows)),
                                  dtype=dtype, device=dev)
            t = system.tables(dev)
            for p, r in ((None, None), (pars, rhs)):
                same(lm_jacobian.products(t, x, p, r),
                     lm_jacobian.products_reference(t, x, p, r), f"{name} {dtype} x{LMJ_KINDS_B}")
    print(f"phase3j: the 23 kinds x{LMJ_KINDS_B} lanes, float32 and float64, with and without "
          f"the rhs: bit-equal to the plain version", flush=True)

    cons, x0 = fixtures.rect_chain(64)
    chain = compile_system(cons, n_vars=len(x0))
    noise = rng.normal(0.0, 0.05, (REPS + 1, LMJ_B, len(x0)))
    factors = [rng.uniform(0.8, 1.25, (LMJ_B,) + b.par.shape) for b in chain.blocks]
    rhs64 = rng.normal(0.0, 1.0, (LMJ_B, chain.n_rows))
    rec = None
    for dtype in (torch.float32, torch.float64):
        system = chain.astype(dtype)
        t = system.tables(dev)
        xs = [torch.as_tensor(x0 + noise[k], dtype=dtype, device=dev) for k in range(REPS + 1)]
        pars = tuple(torch.as_tensor(b.par * f, dtype=dtype, device=dev)
                     for b, f in zip(system.blocks, factors))
        rhs = torch.as_tensor(rhs64, dtype=dtype, device=dev)
        plain_ms = {}
        for label, r in (("without the rhs", None), ("with the rhs", rhs)):
            got = lm_jacobian.products(t, xs[0], pars, r)
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            want = lm_jacobian.products_reference(t, xs[0], pars, r)
            ev[1].record()
            torch.cuda.synchronize()
            plain_ms[label] = ev[0].elapsed_time(ev[1])
            err = max(err, same(got, want, f"rect_chain(64) {dtype} x{LMJ_B} {label}"))
            del got, want
        print(f"phase3j: rect_chain(64) x{LMJ_B} {dtype}, per-lane parameters, with and "
              f"without the rhs: bit-equal to the plain version (max |kernel - plain| "
              f"{err!r})", flush=True)
        # float64: the kernel alone without the rhs (the f64 paths pass none).
        timing = phase3j_timing(t, xs, pars, rhs if dtype == torch.float32 else None,
                                plain_ms, system.n_vars, card, dtype)
        rec = rec or timing
        del xs, pars, rhs
        torch.cuda.empty_cache()
    rec["max_abs_err"] = err
    print(f"phase3j ok: {time.perf_counter() - t_start:.1f} s", flush=True)
    return rec


def phase3j_timing(t, xs, pars, rhs, plain_ms, n_vars, card, dtype):
    """The Jacobian kernel alone on ``xs[1:]`` (one rep each): CUDA events
    around LMJ_INNER launches, median of REPS, without ``rhs`` and, when
    given, with it. Returns the record of the run without the rhs."""
    from ezpz_tpu_torch.ops import lm_jacobian

    rec = None
    for label, r in (("without the rhs", None), ("with the rhs", rhs))[:1 + (rhs is not None)]:
        # LMJ_INNER launches between the events, so the device does not wait
        # on the wrapper's host work between them.
        _wall, ms, walls = timed(around(
            lambda k: [lm_jacobian.products(t, xs[k + 1], pars, r) for _ in range(LMJ_INNER)]))
        ms = ms[0] / LMJ_INNER
        bound_ms = 1e3 * lm_jacobian_bytes(t, LMJ_B, n_vars) / HBM_BYTES_PER_S
        print(f"phase3j lm_jacobian rect_chain(64) x{LMJ_B} {dtype} {label}: {ms!r} ms a "
              f"launch (CUDA events around {LMJ_INNER} launches, median of {REPS}, fresh x; "
              f"host {[round(w * 1e3 / LMJ_INNER, 3) for w in walls]} ms a call), bound "
              f"{bound_ms!r} ms (bytes), {100 * bound_ms / ms!r}% of it; plain version "
              f"{plain_ms[label]!r} ms (once); card: {card}", flush=True)
        if rec is None:
            rec = dict(ms=ms, plain_ms=plain_ms[label], bound_ms=bound_ms, bound_by="bytes")
    return rec


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


def profiled(fn):
    """``fn()`` once on the card under ``torch.profiler``: its kernel
    launches, device-to-host copies, the kernels' summed device time and
    the wall time (profiler overhead included), and the device's idle share
    of that wall time, as one line."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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


def profile_solve(cs, dev):
    """One warm ``solve_with_config`` on the card under ``torch.profiler``."""
    from ezpz_tpu_torch.config import Config

    return profiled(lambda: cs.solve_with_config(Config(), device=dev))


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


# Phase 8: the coupled path at bench.py's operating point.
COUPLED_LINES = 600
COUPLED_COPIES = 1024
COUPLED_PARTS = 120
COUPLED_SIGMA = 1e-3
COUPLED_SIDE_COPIES = 64
COUPLED_CPU_COPIES = 4
# (P, m, kb, n_b, bw) of the chain at COUPLED_PARTS parts.
COUPLED_STRUCTURE = (120, 16, 12, 952, 11)
# Two solves that each stop at a residual <= 1e-8 can put the chain's
# far end up to one residual per link apart (the equal-length links pass
# each length error on): x is compared across boundary solvers and
# precisions to COUPLED_LINES * 1e-8. (Measured on the CPU at 4 copies:
# dense against banded 2.7e-7, f64 against mixed 1.2e-6.)
COUPLED_X_TOL = COUPLED_LINES * 1e-8
# Dense library factorizations of the band's (B, n_b, n_b) matrix: timed
# once when one call takes longer than this (it is only a yardstick).
LIBRARY_ONCE_MS = 1000.0


def coupled_solver(cons, n_vars, device, boundary="banded", precision="mixed"):
    from ezpz_tpu_torch.parallel import BlockSchurSolver

    return BlockSchurSolver(cons, n_vars, n_parts=COUPLED_PARTS,
                            boundary_solver=boundary, precision=precision,
                            device=device)


def same_flags(label, res, sat, ref_res, ref_sat, iterations=True, x_tol=X_TOL):
    """Converged, satisfied and degenerate equal lane for lane (and
    iterations, when asked), x within ``x_tol``; returns max |x - x_ref|."""
    import torch

    ok = (torch.equal(res.converged.cpu(), ref_res.converged.cpu())
          and torch.equal(sat.cpu(), ref_sat.cpu())
          and torch.equal(res.deg.cpu(), ref_res.deg.cpu()))
    if iterations:
        ok = ok and torch.equal(res.iterations.cpu(), ref_res.iterations.cpu())
    err = float((res.x.cpu() - ref_res.x.cpu()).abs().max())
    print(f"{label}: flags equal={ok} max|dx|={err!r}", flush=True)
    if not ok or err > x_tol:
        raise SystemExit(f"chip_smoke: {label} differs")
    return err


def banded_bound_ms(B, n, bw, itemsize):
    """The least time for one banded solve of B lanes: the band, the
    right-hand side and x (and the fail flags) moved once, against the
    factor's and both substitutions' operations per row (bw^2 + 3 bw + 2,
    then 2 bw + 2 twice) over the f32 or f64 rate."""
    nbytes = B * n * (bw + 3) * itemsize + B
    ops = B * n * (bw * bw + 7 * bw + 6)
    rate = F32_OPS_PER_S if itemsize == 4 else F64_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def events_ms(fn):
    """Median ms of ``fn()`` between two CUDA events over REPS calls, after
    one warm call."""
    fn()
    return timed(around(lambda _k: fn()))[1][0]


def phase8_split(solver, x0s, card):
    """One ``solve_batch`` with CUDA events around each part of every LM
    step: the partitioned Jacobian pass, the interior solves, the boundary
    solve, the rest of the step (contractions, assembly, scatter) and the
    rest of the trip (trial residual, accept/reject, the host's live-lane
    check). Returns ms per trip by part and the trip count."""
    import torch

    from ezpz_tpu_torch.parallel import block_schur

    marks = {"jacobian": [], "interior": [], "boundary": [], "step": []}

    def timed_call(key, fn):
        def wrapper(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            marks[key].append(ev)
            return out
        return wrapper

    saved = (block_schur.spd_solve_multi_batched, block_schur.banded_spd_solve)
    block_schur.spd_solve_multi_batched = timed_call("interior", saved[0])
    block_schur.banded_spd_solve = timed_call("boundary", saved[1])
    solver._partition_normal_eq = timed_call("jacobian", solver._partition_normal_eq)
    solver._schur_step = timed_call("step", solver._schur_step)
    try:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        solver.solve_batch(x0s)
        ev[1].record()
        torch.cuda.synchronize()
    finally:
        block_schur.spd_solve_multi_batched, block_schur.banded_spd_solve = saved
        del solver._partition_normal_eq, solver._schur_step
    total = ev[0].elapsed_time(ev[1])
    summed = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in marks.items()}
    trips = len(marks["step"])
    split = {
        "jacobian": summed["jacobian"] / trips,
        "interior": summed["interior"] / trips,
        "boundary": summed["boundary"] / trips,
        "rest of step": (summed["step"] - summed["jacobian"] - summed["interior"]
                         - summed["boundary"]) / trips,
        "loop and sync": (total - summed["step"]) / trips,
    }
    print(f"phase8 split per LM trip ({trips} trips, {total!r} ms for the solve, CUDA "
          f"events): " + ", ".join(f"{k} {v!r} ms" for k, v in split.items())
          + f"; card: {card}", flush=True)
    return split, trips


def band_backward_error(Ab, x, b) -> float:
    """Largest normwise backward error over the lanes of ``x`` (B, n) for
    the symmetric banded systems of lower bands ``Ab`` (B, n, bw+1),
    computed in f64: ``|A x - b|_inf / (|A|_inf |x|_inf + |b|_inf)``. A
    backward-stable solve has it at a small multiple of its dtype's eps
    however ill-conditioned ``A`` is; its forward error is then up to the
    condition number times that."""
    import torch

    A, x, b = Ab.double(), x.double(), b.double()
    n, bwp1 = A.shape[1:]
    bw = bwp1 - 1
    rows = torch.arange(n, device=A.device)
    y = torch.zeros_like(x)
    norm = torch.zeros_like(x)
    for d in range(bwp1):
        # The lower entry A[i, i - bw + d] and, off the diagonal, its
        # mirror A[i - bw + d, i].
        keep = rows - bw + d >= 0
        col = (rows - bw + d)[keep]
        a = A[:, keep, d]
        y[:, keep] += a * x[:, col]
        norm[:, keep] += a.abs()
        if d < bw:
            y.index_add_(1, col, a * x[:, keep])
            norm.index_add_(1, col, a.abs())
    scale = norm.max(1).values * x.abs().max(1).values + b.abs().max(1).values
    return float(((y - b).abs().max(1).values / scale).max())


# Backward error (``band_backward_error``) a banded solve must reach.
BACKWARD_TOL = {"torch.float32": 1e-6, "torch.float64": 1e-13}


@contextlib.contextmanager
def forced_route(route):
    """Within the block, ``banded_spd.route_for`` names ``route`` (the
    wrapper launches that kernel whatever the band)."""
    from ezpz_tpu_torch.ops import banded_spd

    saved = banded_spd.route_for
    banded_spd.route_for = lambda *_a: route
    try:
        yield
    finally:
        banded_spd.route_for = saved


def dense_library(Ab, b, chunk=None):
    """The PyTorch call that computes the banded solve on the dense matrix
    of the same band (``cholesky_ex`` + ``cholesky_solve``, the dense
    boundary's), in chunks of ``chunk`` lanes when the whole batch's dense
    matrices do not fit the card. Returns (x, ms): one chunk's dense
    matrix is built outside the timed calls; ms is the chunks' summed
    time, each chunk's the median of REPS CUDA-event calls (or one host-
    clock call when that takes longer than LIBRARY_ONCE_MS)."""
    import torch

    B, n, bwp1 = Ab.shape
    bw = bwp1 - 1
    rows = torch.arange(n, device=Ab.device)[:, None]
    cols = rows - bw + torch.arange(bwp1, device=Ab.device)[None, :]
    keep = (cols >= 0).expand(n, bwp1)
    r_idx, c_idx = rows.expand(n, bwp1)[keep], cols[keep]
    xs, total = [], 0.0
    step = chunk or B
    for lo in range(0, B, step):
        ab, rhs = Ab[lo:lo + step], b[lo:lo + step]
        dense = torch.zeros((ab.shape[0], n, n), dtype=Ab.dtype, device=Ab.device)
        dense[:, r_idx, c_idx] = ab[:, keep]
        dense[:, c_idx, r_idx] = ab[:, keep]

        def library():
            L, _info = torch.linalg.cholesky_ex(dense)
            return torch.cholesky_solve(rhs[..., None], L)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xs.append(library()[..., 0])
        torch.cuda.synchronize()
        once = (time.perf_counter() - t0) * 1e3
        total += once if once > LIBRARY_ONCE_MS else events_ms(library)
        del dense
    torch.cuda.empty_cache()
    return torch.cat(xs), total


def phase8_kernel(band, rhs, card, label="phase8", dtypes=None, also=(), forced=(),
                  library_chunk=None):
    """The banded kernel alone at the operating point's band (the first
    boundary solve of a main-path run): against its plain version on the
    card at full size (once: a chain of ~n (bw^2 + 3 bw) launches), and
    against the PyTorch call that computes the same function on the dense
    matrix of the same band (``dense_library``, in chunks of
    ``library_chunk`` lanes where given), in f32 and f64 (or ``dtypes``).
    Kernel and plain version must agree bit for bit (the same operations
    in the same order) and the kernel's answer must be backward stable
    (BACKWARD_TOL); the library's backward error and its difference from
    the kernel are printed. ``also`` holds more (band, rhs) pairs of the
    same n and bw (another call site's first band): the kernel solves each
    at its own batch, and the plain version takes their lanes beside the
    band's in its one call (its lanes are independent elementwise chains,
    so a lane's answer does not depend on the others). ``forced`` names
    other routes of the wrapper that take this band: each is launched on
    it with the route forced (``forced_route``), must equal the plain
    version bit for bit too, and is timed beside the wrapper's own route.
    Returns the record of the kernels line (f32's, if run), timed on
    ``band``; ``rec["forced"][route]`` holds each forced route's ms and
    max |x - x_plain|."""
    import torch

    from ezpz_tpu_torch.ops import banded

    B, n, bwp1 = band.shape
    bw = bwp1 - 1
    rec = None
    for dtype in dtypes or (torch.float32, torch.float64):
        Ab, b = band.to(dtype), rhs.to(dtype)
        pairs = [(Ab, b)] + [(a.to(dtype), r.to(dtype)) for a, r in also]
        outs = [banded.banded_spd_solve(a, r) for a, r in pairs]
        x, fail = (torch.cat(v) for v in zip(*outs))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xr, failr = banded.banded_spd_reference(*(torch.cat(v) for v in zip(*pairs)))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        bits = torch.equal(x, xr) and torch.equal(fail, failr)
        err = float((x - xr).abs().max())
        first = None if bits else int((x != xr).any(0).nonzero()[0])
        if not bits or bool(fail.any()):
            raise SystemExit(f"chip_smoke: {label} banded kernel differs from its plain "
                             f"version ({dtype}, n={n}: max|dx|={err!r}, first differing "
                             f"row {first}, fails {int(fail.sum())} / {int(failr.sum())})")
        x = x[:B]
        kms = events_ms(lambda: banded.banded_spd_solve(Ab, b))
        others = {}
        for route in forced:
            with forced_route(route):
                xf, ff = banded.banded_spd_solve(Ab, b)
                fms = events_ms(lambda: banded.banded_spd_solve(Ab, b))
            same = torch.equal(xf, xr[:B]) and torch.equal(ff, failr[:B])
            others[route] = dict(ms=fms, max_abs_err=float((xf - xr[:B]).abs().max()))
            print(f"{label} {route} route forced on the band {dtype}: {fms!r} ms per call "
                  f"(CUDA events, median of {REPS}) against the wrapper's own route's "
                  f"{kms!r} ms; bit-equal to the plain version {same}; card: {card}",
                  flush=True)
            if not same:
                raise SystemExit(f"chip_smoke: {label} {route} route differs from the "
                                 f"plain version ({dtype})")
        lx, lib_ms = dense_library(Ab, b, library_chunk)
        lerr = float((lx - x).abs().max() / x.abs().max())
        kbe, lbe = band_backward_error(Ab, x, b), band_backward_error(Ab, lx, b)
        del lx
        bound, bound_by = banded_bound_ms(B, n, bw, Ab.element_size())
        chunked = f", in chunks of {library_chunk} lanes, summed" if library_chunk else ""
        print(f"{label} banded kernel {dtype}: B={B} n={n} bw={bw}: {kms!r} ms per call "
              f"(CUDA events, median of {REPS}), {kms * 1e3 / n!r} us per row, "
              f"{kms * 1e6 / (n * B)!r} ns per row per lane; plain version "
              f"{plain_ms!r} ms (once, host clock, {xr.shape[0]} lanes: also batches "
              f"{[a.shape[0] for a, _ in also]}), bit-equal {bits}; dense "
              f"cholesky_ex + cholesky_solve {lib_ms!r} ms{chunked}; backward "
              f"error kernel {kbe!r}, library {lbe!r}; relative difference library - "
              f"kernel {lerr!r}; bound {bound!r} ms ({bound_by}, "
              f"{100 * bound / kms:.2f}% of the kernel's time); card: {card}", flush=True)
        if kbe > BACKWARD_TOL[str(dtype)]:
            raise SystemExit(f"chip_smoke: {label} banded kernel's backward error {kbe!r} "
                             f"exceeds {BACKWARD_TOL[str(dtype)]!r}")
        if rec is None or dtype == torch.float32:
            rec = dict(max_abs_err=err, ms=kms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by=bound_by, library_ms=lib_ms, forced=others)
    return rec


@contextlib.contextmanager
def first_kernel_band(banded_spd):
    """Within the block, ``banded_spd.banded_spd_cuda`` keeps a copy of its
    first call's band, right-hand side and ``lam`` (None when the call had
    none) in the list it yields."""
    captured = []
    solve = banded_spd.banded_spd_cuda

    def capture(band, rhs, lam=None):
        if not captured:
            captured.append((band.clone(), rhs.clone(), None if lam is None else lam.clone()))
        return solve(band, rhs, lam=lam)

    banded_spd.banded_spd_cuda = capture
    try:
        yield captured
    finally:
        banded_spd.banded_spd_cuda = solve


def damped_copy(band, lam):
    """A copy of ``band`` (B, n, bw+1) with ``lam`` (B,) added to its
    diagonal column."""
    out = band.clone()
    out[..., -1] += lam[:, None]
    return out


def retry_lanes(banded_spd, run):
    """``run()`` with its damped one-launch solves counted: (those calls,
    the lanes of theirs whose raw-lambda factor failed, which the lane
    kernel's retry re-solved in float32; each such call's band is damped
    beforehand and solved once more without ``lam`` to count them)."""
    import torch

    solve = banded_spd.banded_spd_cuda
    seen = [0, 0]

    def counted(band, rhs, lam=None):
        if lam is not None:
            seen[0] += 1
            if band.dtype == torch.float32:
                seen[1] += int(solve(damped_copy(band, lam), rhs)[1].sum())
        return solve(band, rhs, lam=lam)

    banded_spd.banded_spd_cuda = counted
    try:
        run()
    finally:
        banded_spd.banded_spd_cuda = solve
    return tuple(seen)


def damped_kernel(band, rhs, lam, card, label):
    """The lane kernel's damped one-launch solve (the main path's mode on
    the lane route) alone on a run's first undamped band, right-hand side
    and lambda (``first_kernel_band``), in f32 and f64.
    ``banded_spd_cuda(band, rhs, lam=lam)`` must equal, torch.equal on x
    and the fail flags, ``solver._rescued`` over the plain version
    (``banded_spd_reference`` on copies of the band damped by lambda, in
    f32 again by the floored lambda), with lambda -1 on lane 1, NaN on
    lane 2 (both factors fail) and -2 max|diagonal| on lanes 3 and B - 1
    (the raw factor fails; in f32 the in-kernel retry solves them again):
    the raw factor must fail on lanes 2, 3 and B - 1, and the f64 flags
    must be the raw ones (no retry). Then the launch at the run's own
    lambdas (CUDA events, median of REPS) beside the undamped launch on
    the band damped beforehand, the bound, the dense library on that band
    and the kernel's backward error there. Returns the f32 record."""
    import torch

    from ezpz_tpu_torch.ops import banded, banded_spd
    from ezpz_tpu_torch.solver import _rescued

    B, n, bwp1 = band.shape
    bw = bwp1 - 1
    rec = None
    for dtype in (torch.float32, torch.float64):
        Ab, b, lam_run = band.to(dtype), rhs.to(dtype), lam.to(dtype)
        lam_t = lam_run.clone()
        lam_t[1], lam_t[2] = -1.0, float("nan")
        for lane in (3, B - 1):
            lam_t[lane] = -2.0 * Ab[lane, :, bw].abs().max()
        x, fail = banded_spd.banded_spd_cuda(Ab, b, lam=lam_t)
        raw = banded_spd.banded_spd_cuda(damped_copy(Ab, lam_t), b)[1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xr, failr = _rescued(lambda l: banded.banded_spd_reference(damped_copy(Ab, l), b),
                             lam_t, Ab[..., bw])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        bits = torch.equal(x, xr) and torch.equal(fail, failr)
        raw_lanes = raw.nonzero().flatten().tolist()
        resolved = (raw & ~fail).nonzero().flatten().tolist()
        engaged = {2, 3, B - 1} <= set(raw_lanes)
        retried = dtype == torch.float64 or not bool(fail[3]) or not bool(fail[B - 1])
        print(f"{label} damped one launch {dtype}: B={B} n={n} bw={bw}: bit-equal to "
              f"_rescued over the plain version {bits} ({plain_ms!r} ms once, host clock); "
              f"raw factor failed on lanes {raw_lanes}, the launch's fail flags "
              f"{fail.nonzero().flatten().tolist()}, lanes the in-kernel retry re-solved "
              f"{resolved}", flush=True)
        if not bits or not engaged or (dtype == torch.float64 and not torch.equal(fail, raw)):
            err = float((x - xr).nan_to_num().abs().max())
            raise SystemExit(f"chip_smoke: {label} damped one launch differs from _rescued "
                             f"over the plain version or its retry was not exercised "
                             f"({dtype}: max|dx|={err!r}, fails {fail.nonzero().flatten()} / "
                             f"{failr.nonzero().flatten()}, raw {raw_lanes})")
        if not retried:
            raise SystemExit(f"chip_smoke: {label} in-kernel retry solved neither lane 3 nor "
                             f"lane {B - 1} ({dtype})")
        pre = damped_copy(Ab, lam_run)
        xk, fk = banded_spd.banded_spd_cuda(Ab, b, lam=lam_run)
        if bool(fk.any()):
            raise SystemExit(f"chip_smoke: {label} damped one launch failed "
                             f"{int(fk.sum())} of the run's lanes ({dtype})")
        kms = events_ms(lambda: banded_spd.banded_spd_cuda(Ab, b, lam=lam_run))
        ums = events_ms(lambda: banded_spd.banded_spd_cuda(pre, b))
        lx, lib_ms = dense_library(pre, b)
        kbe, lbe = band_backward_error(pre, xk, b), band_backward_error(pre, lx, b)
        del lx
        bound, bound_by = banded_bound_ms(B, n, bw, Ab.element_size())
        print(f"{label} damped one launch {dtype}: {kms!r} ms per call (CUDA events, median "
              f"of {REPS}; the undamped launch on the band damped beforehand {ums!r} ms), "
              f"{kms * 1e6 / (n * B)!r} ns per row per lane; dense cholesky_ex + "
              f"cholesky_solve {lib_ms!r} ms; backward error kernel {kbe!r}, library "
              f"{lbe!r}; bound {bound!r} ms ({bound_by}, {100 * bound / kms:.2f}% of the "
              f"kernel's time); card: {card}", flush=True)
        if kbe > BACKWARD_TOL[str(dtype)]:
            raise SystemExit(f"chip_smoke: {label} damped one launch's backward error "
                             f"{kbe!r} exceeds {BACKWARD_TOL[str(dtype)]!r}")
        if rec is None:
            rec = dict(ms=kms, undamped_ms=ums, plain_ms=plain_ms, bound_ms=bound,
                       bound_by=bound_by, library_ms=lib_ms, resolved=len(resolved))
    return rec


@contextlib.contextmanager
def first_band(module):
    """Within the block, ``module.banded_spd_solve`` (a caller's import of
    ``ops.banded.banded_spd_solve``) keeps a copy of its first call's band
    and right-hand side in the list it yields."""
    captured = []
    solve = module.banded_spd_solve

    def capture(band, rhs):
        if not captured:
            captured.append((band.clone(), rhs.clone()))
        return solve(band, rhs)

    module.banded_spd_solve = capture
    try:
        yield captured
    finally:
        module.banded_spd_solve = solve


def phase8(dev, card):
    """The coupled path (``bench.py``'s second headline) on the card."""
    import numpy as np
    import torch

    from ezpz_tpu_torch.benches import coupled_bench
    from ezpz_tpu_torch.ops import banded, banded_spd
    from ezpz_tpu_torch.parallel import block_schur

    t_start = time.perf_counter()
    cons, x0 = coupled_bench.build_problem(COUPLED_LINES)
    n = len(x0)
    rng = np.random.default_rng(8)
    noise = rng.normal(0.0, COUPLED_SIGMA, (COUPLED_COPIES + REPS, n))
    x0s = torch.as_tensor(x0 + noise[:COUPLED_COPIES], device=dev)
    solver = coupled_solver(cons, n, dev)
    print(f"phase8 structure: {n} variables, {len(cons)} constraints, P={solver.P} "
          f"m={solver.m} kb={solver.kb} n_b={solver.n_b} bw={solver.band_bw} "
          f"boundary={solver.boundary_solver}", flush=True)
    if (solver.P, solver.m, solver.kb, solver.n_b, solver.band_bw) != COUPLED_STRUCTURE:
        raise SystemExit("chip_smoke: the coupled chain's structure is not bench.py's")
    solver.solve_batch(x0s[:2])  # warm-up: the library's first calls

    # The main-path run: counts from zero, gate on its answers.
    banded_spd.LAUNCHES = dict.fromkeys(banded_spd.LAUNCHES, 0)
    torch.cuda.reset_peak_memory_stats()
    res, sat = solver.solve_batch(x0s)
    torch.cuda.synchronize()
    routes = dict(banded_spd.LAUNCHES)
    launches = routes["lanes"]
    peak = torch.cuda.max_memory_allocated()
    r, _deg = solver.system.residual_and_flags(res.x)
    rmax = float(r.abs().max())
    conv, sat_all = bool(res.converged.all()), bool(sat.all())
    print(f"phase8 gate: {COUPLED_COPIES} copies, converged={conv} satisfied={sat_all} "
          f"f64_residual_max={rmax!r} iterations {int(res.iterations.min())}-"
          f"{int(res.iterations.max())}; banded launches by route {routes}; peak device "
          f"memory {peak!r} bytes", flush=True)
    if not (conv and sat_all and rmax <= 1e-8) or launches == 0:
        raise SystemExit("chip_smoke: phase8 main path failed its gate or never "
                         "launched the banded kernel's lanes route")

    # The same run with the warp kernel's route forced: bit for bit (both
    # kernels are the plain version's arithmetic). A check only: the warp
    # kernel's record is phase 8w's main-path run at bw = 27.
    with forced_route("warp"):
        banded_spd.LAUNCHES = dict.fromkeys(banded_spd.LAUNCHES, 0)
        warp_res, warp_sat = solver.solve_batch(x0s)
        torch.cuda.synchronize()
        warp_launches = banded_spd.LAUNCHES["warp"]
    same = (torch.equal(warp_res.x, res.x) and torch.equal(warp_res.iterations, res.iterations)
            and torch.equal(warp_sat, sat))
    print(f"phase8 warp route forced: {warp_launches} warp launches, bit-equal to the lanes "
          f"route's run: {same}", flush=True)
    if not same or warp_launches == 0:
        raise SystemExit("chip_smoke: phase8 with the warp route forced differs")

    # A second identical run (capturing the first boundary solve's inputs):
    # equal bit for bit.
    with first_band(block_schur) as captured:
        again, again_sat = solver.solve_batch(x0s)
    same = (torch.equal(again.x, res.x) and torch.equal(again.iterations, res.iterations)
            and torch.equal(again_sat, sat))
    print(f"phase8 second run bit-equal: {same}", flush=True)
    if not same:
        raise SystemExit("chip_smoke: phase8 is not deterministic from run to run")

    # The same solve with the plain banded version on the card.
    block_schur.banded_spd_solve = banded.banded_spd_reference
    try:
        plain, plain_sat = solver.solve_batch(x0s)
    finally:
        block_schur.banded_spd_solve = banded.banded_spd_solve
    same_flags("phase8 plain banded version on the card", plain, plain_sat, res, sat)

    # Dense and CG boundaries at COUPLED_SIDE_COPIES lanes; f64 on the CPU.
    k = COUPLED_SIDE_COPIES
    head = res._replace(**{f: getattr(res, f)[:k] for f in res._fields})
    for boundary in ("dense", "cg"):
        other, other_sat = coupled_solver(cons, n, dev, boundary).solve_batch(x0s[:k])
        same_flags(f"phase8 {boundary} boundary x{k}", other, other_sat, head, sat[:k],
                   iterations=boundary == "dense", x_tol=COUPLED_X_TOL)
    k = COUPLED_CPU_COPIES
    cpu_res, cpu_sat = coupled_solver(cons, n, "cpu", precision="f64").solve_batch(
        x0s[:k].cpu())
    head = res._replace(**{f: getattr(res, f)[:k] for f in res._fields})
    same_flags(f"phase8 f64 on the CPU x{k}", cpu_res, cpu_sat, head, sat[:k],
               iterations=False, x_tol=COUPLED_X_TOL)

    # Timing: solves/s on fresh inputs, the split, batch-1 latency,
    # launches, the kernel alone.
    walls = []
    for rep in range(REPS):
        xs = x0s + torch.as_tensor(noise[COUPLED_COPIES + rep], device=dev) * 1e-3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve_batch(xs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[REPS // 2]
    print(f"phase8 coupled path: {COUPLED_COPIES / wall!r} solves/s of the 2400-var coupled "
          f"chain, median {wall * 1e3!r} ms per {COUPLED_COPIES}-copy solve_batch, reps "
          f"{[round(w * 1e3, 3) for w in walls]} ms; card: {card}", flush=True)
    phase8_split(solver, x0s, card)
    lat = []
    for rep in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(x0 + noise[rep])
        lat.append(time.perf_counter() - t0)
    print(f"phase8 solve batch-1 latency: median {sorted(lat)[REPS // 2] * 1e3!r} ms, reps "
          f"{[round(t * 1e3, 3) for t in lat]} ms; card: {card}", flush=True)
    print(f"phase8 profiled solve_batch: {profiled(lambda: solver.solve_batch(x0s))}",
          flush=True)
    rec = phase8_kernel(*captured[0], card, forced=("warp",))
    print(f"phase8 ok: {time.perf_counter() - t_start:.1f} s", flush=True)
    return dict(rec, launches=launches)


# Phase 8l: phase 8's chain at LANES_COPIES copies, past
# ``banded_spd.LANES_MIN_BATCH``: "auto" resolves to banded (bw = 11) and
# the one-thread-per-lane kernel runs on the main path. The dense library
# of its band (8192 x 952^2, 59 GB in f64) is taken in chunks.
LANES_COPIES = 8192
LIBRARY_CHUNK = 1024


def phase8_lanes(dev, card):
    """The coupled chain at LANES_COPIES copies through
    ``BlockSchurSolver(boundary_solver="auto")`` (banded, mixed) on the
    card, counts from zero, with phase 8's gate and the lane kernel's
    route launched; then that kernel alone on the run's first band
    (``phase8_kernel``: bit-equal to the plain version in f32 and f64, the
    warp kernel forced on the same band and timed beside it, the dense
    library in chunks of LIBRARY_CHUNK lanes, the bound). Returns the
    kernels line's record."""
    import numpy as np
    import torch

    from ezpz_tpu_torch.benches import coupled_bench
    from ezpz_tpu_torch.ops import banded_spd
    from ezpz_tpu_torch.parallel import BlockSchurSolver, block_schur

    t_start = time.perf_counter()
    cons, x0 = coupled_bench.build_problem(COUPLED_LINES)
    n = len(x0)
    rng = np.random.default_rng(88)
    x0s = torch.as_tensor(x0 + rng.normal(0.0, COUPLED_SIGMA, (LANES_COPIES, n)), device=dev)
    solver = BlockSchurSolver(cons, n, n_parts=COUPLED_PARTS, boundary_solver="auto",
                              precision="mixed", device=dev)
    got = (solver.P, solver.m, solver.kb, solver.n_b, solver.band_bw)
    print(f"phase8l structure: P={got[0]} m={got[1]} kb={got[2]} n_b={got[3]} bw={got[4]} "
          f"auto -> {solver.boundary_solver}; route at {LANES_COPIES} lanes: "
          f"{banded_spd.route_for(LANES_COPIES, got[4], 4)}", flush=True)
    if got != COUPLED_STRUCTURE or solver.boundary_solver != "banded":
        raise SystemExit("chip_smoke: phase8l structure is not phase 8's banded chain")
    solver.solve_batch(x0s[:2])  # warm-up: the library's first calls
    banded_spd.LAUNCHES = dict.fromkeys(banded_spd.LAUNCHES, 0)
    torch.cuda.reset_peak_memory_stats()
    with first_band(block_schur) as captured:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, sat = solver.solve_batch(x0s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    routes = dict(banded_spd.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    r, _deg = solver.system.residual_and_flags(res.x)
    rmax = float(r.abs().max())
    conv, sat_all = bool(res.converged.all()), bool(sat.all())
    print(f"phase8l gate: {LANES_COPIES} copies, converged={conv} satisfied={sat_all} "
          f"f64_residual_max={rmax!r} iterations {int(res.iterations.min())}-"
          f"{int(res.iterations.max())}; {wall * 1e3!r} ms (host clock, once); banded "
          f"launches by route {routes}; peak device memory {peak!r} bytes; card: {card}",
          flush=True)
    if not (conv and sat_all and rmax <= 1e-8) or routes["lanes"] == 0:
        raise SystemExit("chip_smoke: phase8l failed its gate or never launched the "
                         "banded kernel's lanes route")
    del x0s, res, sat, r
    rec = phase8_kernel(*captured[0], card, label="phase8l lane kernel", forced=("warp",),
                        library_chunk=LIBRARY_CHUNK)
    print(f"phase8l ok: {time.perf_counter() - t_start:.1f} s", flush=True)
    return dict(rec, launches=routes["lanes"])


# Phase 8w: a boundary band wider than 32. Every 4th part's variables
# go to the part 3 to its right (WIDE_MAP, ``coupled_bench.moved_parts``),
# which widens the chain's boundary band past the warp and lane kernels'
# 32: "auto" resolves it to banded (both packages' rule has no cap) and
# the dynamic-width kernel runs. GENERAL_MAP (every 8th part to the part 7
# to its right) widens it to 67, past the widest capacity the warp kernel
# had before the dynamic-width kernel (64): the dynamic-width kernel runs
# on the main path, and in a second run the general-width kernel with the
# route forced.
WIDE_MAP = (4, 3)
WIDE_STRUCTURE = (952, 35, "banded")
GENERAL_MAP = (8, 7)
GENERAL_STRUCTURE = (952, 67, "banded")
# Every 4th part moved 2 to its right widens the band to 27: past the lane
# kernel's widest capacity (16), so the warp kernel takes it at any batch.
WARP_MAP = (4, 2)
WARP_STRUCTURE = (952, 27, "banded")


def wide_solve(cons, n, x0s, part_of_var, structure, precision, dev, card, label, route,
               force=None):
    """One ``BlockSchurSolver(part_of_var=..., boundary_solver="auto")``
    main-path run on the card, counts from zero, with phase 8's gate (the
    banded kernel's ``force`` route forced for the run, when given);
    returns (result, the first boundary solve's band and rhs, the route's
    launches, the solver)."""
    import torch

    from ezpz_tpu_torch.ops import banded_spd
    from ezpz_tpu_torch.parallel import BlockSchurSolver, block_schur

    solver = BlockSchurSolver(cons, n, part_of_var=part_of_var, boundary_solver="auto",
                              precision=precision, device=dev)
    got = (solver.n_b, solver.band_bw, solver.boundary_solver)
    print(f"{label} structure: P={solver.P} m={solver.m} kb={solver.kb} n_b={got[0]} "
          f"bw={got[1]} auto -> {got[2]}", flush=True)
    if got != structure:
        raise SystemExit(f"chip_smoke: {label} structure {got} is not {structure}")
    with forced_route(force) if force else contextlib.nullcontext():
        solver.solve_batch(x0s[:2])  # warm-up: the library's first calls
        banded_spd.LAUNCHES = dict.fromkeys(banded_spd.LAUNCHES, 0)
        with first_band(block_schur) as captured:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, sat = solver.solve_batch(x0s)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    routes = dict(banded_spd.LAUNCHES)
    r, _deg = solver.system.residual_and_flags(res.x)
    rmax = float(r.abs().max())
    conv, sat_all = bool(res.converged.all()), bool(sat.all())
    print(f"{label} gate: {len(x0s)} copies, converged={conv} satisfied={sat_all} "
          f"f64_residual_max={rmax!r} iterations {int(res.iterations.min())}-"
          f"{int(res.iterations.max())}; {wall * 1e3!r} ms (host clock, once); banded "
          f"launches by route {routes}{f' ({force} forced)' if force else ''}; card: {card}",
          flush=True)
    if not (conv and sat_all and rmax <= 1e-8) or routes[route] == 0:
        raise SystemExit(f"chip_smoke: {label} failed its gate or never launched the "
                         f"banded kernel's {route} route")
    return res, captured[0], routes[route], solver


def phase8w(dev, card):
    """A boundary band wider than 32 on the card: the 600-line chain, 1024
    copies, 120 parts moved by WIDE_MAP (auto -> banded, n_b = 952, bw =
    35) in mixed and f64 through the dynamic-width kernel, with phase 8's
    gate; a world-1 ``ShardedBlockSchurSolver`` solve on the same parts
    (its own call site); the kernel alone on the mixed run's first band and
    the sharded run's (``phase8_kernel``: bit for bit against the plain
    version, the dense library and the bound), with the other kernels that
    take the band forced on it, bit-equal and timed beside it; then the
    chain moved by GENERAL_MAP (bw = 67) through the dynamic-width kernel,
    the same run with the general-width kernel forced, and the
    dynamic-width kernel alone on the first run's band (``phase8_kernel``,
    the general-width kernel forced beside it); last the chain moved by
    WARP_MAP (bw = 27) through the warp kernel, and that kernel alone on
    its first band in f32 (phase 8's forced run holds it in f64). Returns
    the kernels line's records of the three wide routes and the warp
    kernel's."""
    import numpy as np
    import torch

    from ezpz_tpu_torch.benches import coupled_bench
    from ezpz_tpu_torch.ops import banded_spd
    from ezpz_tpu_torch.parallel import ShardedBlockSchurSolver, hier

    t_start = time.perf_counter()
    cons, x0 = coupled_bench.build_problem(COUPLED_LINES)
    n = len(x0)
    rng = np.random.default_rng(81)
    x0s = torch.as_tensor(x0 + rng.normal(0.0, COUPLED_SIGMA, (COUPLED_COPIES, n)), device=dev)
    q = coupled_bench.moved_parts(n, COUPLED_PARTS, *WIDE_MAP)
    wide_route = banded_spd.route_for(COUPLED_COPIES, WIDE_STRUCTURE[1], 4)
    wide_launches, xs = 0, {}
    for precision in ("mixed", "f64"):
        res, band, launches, solver = wide_solve(
            cons, n, x0s, q, WIDE_STRUCTURE, precision, dev, card, f"phase8w {precision}",
            wide_route)
        wide_launches += launches
        xs[precision] = res.x
        if precision == "mixed":
            wband = band
    err = float((xs["mixed"] - xs["f64"]).abs().max())
    print(f"phase8w mixed against f64: max|dx|={err!r} (tolerance {COUPLED_X_TOL!r})",
          flush=True)
    if err > COUPLED_X_TOL:
        raise SystemExit("chip_smoke: phase8w mixed and f64 solutions differ")

    # The hier.py call site: a world of one on the card, B = 1.
    sharded = ShardedBlockSchurSolver(cons, n, part_of_var=q, boundary_solver="auto",
                                      precision="mixed", device=dev)
    banded_spd.LAUNCHES = dict.fromkeys(banded_spd.LAUNCHES, 0)
    with first_band(hier) as captured:
        t0 = time.perf_counter()
        out = sharded.solve(x0s[0].cpu().numpy())
        wall = time.perf_counter() - t0
    r, _deg = solver.system.residual_and_flags(
        torch.as_tensor(out["x"], device=dev)[None])
    rmax = float(r.abs().max())
    hier_launches = banded_spd.LAUNCHES[wide_route]
    print(f"phase8w ShardedBlockSchurSolver (world 1, B = 1): n_b={sharded.n_b} "
          f"bw={sharded.band_bw} {sharded.boundary_solver}; converged={out['converged']} "
          f"satisfied={bool(out['satisfied'].all())} f64_residual_max={rmax!r} iterations "
          f"{out['iterations']}; {wall * 1e3!r} ms (host clock, once); banded launches by "
          f"route {banded_spd.LAUNCHES}", flush=True)
    if (not (out["converged"] and out["satisfied"].all() and rmax <= 1e-8)
            or hier_launches == 0 or not captured):
        raise SystemExit("chip_smoke: phase8w sharded solve failed or never launched "
                         "the banded kernel")
    wide_launches += hier_launches
    others = tuple(r for r in ("dynamic", "general") if r != wide_route)
    wide = phase8_kernel(*wband, card, label=f"phase8w {wide_route} route at bw = 35",
                         also=captured, forced=others)

    # The dynamic-width kernel on the main path, the general-width kernel on
    # the same path forced, then both alone on the first run's band.
    g = coupled_bench.moved_parts(n, COUPLED_PARTS, *GENERAL_MAP)
    _res, gband, dyn_launches, _solver = wide_solve(
        cons, n, x0s, g, GENERAL_STRUCTURE, "mixed", dev, card, "phase8w dynamic", "dynamic")
    _res, _band, general_launches, _solver = wide_solve(
        cons, n, x0s, g, GENERAL_STRUCTURE, "mixed", dev, card, "phase8w general", "general",
        force="general")
    dyn = phase8_kernel(*gband, card, label="phase8w dynamic-width kernel", forced=("general",))
    general = dict(dyn, launches=general_launches, **dyn["forced"]["general"])

    # The warp kernel on the main path (its own route at bw = 27).
    w = coupled_bench.moved_parts(n, COUPLED_PARTS, *WARP_MAP)
    _res, warp_band, warp_launches, _solver = wide_solve(
        cons, n, x0s, w, WARP_STRUCTURE, "mixed", dev, card, "phase8w warp", "warp")
    warp = phase8_kernel(*warp_band, card, label="phase8w warp kernel at bw = 27",
                         dtypes=(torch.float32,))
    print(f"phase8w ok: {time.perf_counter() - t_start:.1f} s", flush=True)
    return (dict(wide, launches=wide_launches), dict(dyn, launches=dyn_launches), general,
            dict(warp, launches=warp_launches))


# Phase 9: the single-device remainder.
CG_LINES = 200
CG_COPIES = 1024
CG_SIGMA = 1e-3
CG_CPU_COPIES = 4
CG_UNCONVERGED_LINES = 600
# LM settings of the matrix-free and Gauss-Newton solves (Config's).
LM_CFG = (35, 1e-8, 1e-12, 1e-9)
# Dense and matrix-free LM both stop at a residual <= 1e-8 on a chain of
# CG_LINES equal-length links: their x may sit one residual per link apart
# (phase 8's COUPLED_X_TOL argument).
CG_X_TOL = CG_LINES * 1e-8
F64_BUCKET_LANES = 8192
VIZ_ARGS = {
    "points_coincident": (3.0, 2.0),
    "distance": (0.0, 0.0, 3.0),
    "point_line_distance": ((0.0, 0.0), (2.0, 3.0), 1.0),
    "vertical": (1.0, 0.0),
    "horizontal": (0.0, 1.0),
}
VIZ_VIEW = (-6, 6, -6, 6, 240, 240)
EXAMPLE_LINES = {
    "basic": ["|PQ| = 4.000000000"],
    "parser": ["p = (0.000000, 0.000000)"],
    "scale": ["fleet: 4096 sketches, all converged = True",
              "converged = True, all line lengths = 4.000000"],
}


def fleet_solver(system, precision="mixed"):
    from ezpz_tpu_torch.parallel import FleetSolver

    fused = precision == "mixed"
    return FleetSolver(system, batch_params=True, precision=precision,
                       pallas_fused=fused, pallas_trips=3, refine_trips=2)


def same_batch(label, out, ref):
    """Every field of two ``BatchResult``s equal bit for bit."""
    import torch

    ok = all(torch.equal(getattr(out, f).cpu(), getattr(ref, f).cpu())
             for f in ("x", "iterations", "converged", "satisfied", "degenerate"))
    print(f"{label}: bit-equal={ok}", flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: {label} differs")


def phase9a(dev, card):
    """``FleetSolver`` (every visible card) on the main path: the massive
    fixture x COPIES, both buckets, mixed + fused; then f64 on the <2,2>
    bucket's first F64_BUCKET_LANES lanes."""
    import torch

    from ezpz_tpu_torch.ops import fused_fleet

    n_cards = torch.cuda.device_count()
    fleets = massive(dev, fleet_solver)
    print(f"phase9a FleetSolver over {n_cards} visible card(s): "
          f"{[str(d) for d in fleets[0][0].devices]}", flush=True)

    def dispatch(k):
        return [f.solve(xb + k * 1e-9, pb) for f, xb, pb in fleets]

    # The main-path run (offset as in phase 4): counts from zero.
    warm = 2 * REPS + 1
    fused_fleet.LAUNCHES = 0
    outs = dispatch(warm)
    torch.cuda.synchronize()
    launches = fused_fleet.LAUNCHES
    print(f"phase9a launches: fused_fleet={launches} for {len(fleets)} buckets on "
          f"{n_cards} card(s)", flush=True)
    if launches != len(fleets) * n_cards:
        raise SystemExit("chip_smoke: FleetSolver did not launch the fused kernel once "
                         "per bucket per card")
    gate("phase9a", fleets, outs)
    # Each shard against a BatchSolver on the same lanes and card.
    locals_ = [(fused_solver(f.system), xb, pb) for f, xb, pb in fleets]
    for (f, xb, pb), (local, _x, _p), o in zip(fleets, locals_, outs):
        xk, start = xb + warm * 1e-9, 0
        for d, n in zip(f.devices, f._shard_sizes(xb.shape[0])):
            sl = slice(start, start + n)
            local.device = d
            ref = local.solve(xk[sl], tuple(p[sl] for p in pb))
            same_batch(f"phase9a n_vars={f.system.n_vars} shard of {n} lanes on {d} "
                       f"against BatchSolver",
                       type(o)(**{k: getattr(o, k)[sl] for k in vars(o)}), ref)
            start += n
        local.device = dev
    del outs

    fw, (fms,), fwalls = timed(around(dispatch))
    lw, (lms,), lwalls = timed(around(
        lambda k: [s.solve(xb + k * 1e-9, pb) for s, xb, pb in locals_]))
    print(f"phase9a fleet: median {fw * 1e3!r} ms host clock, {fms!r} ms CUDA events per "
          f"main-path solve (reps {[round(w * 1e3, 3) for w in fwalls]} ms); BatchSolver: "
          f"{lw * 1e3!r} ms, {lms!r} ms (reps {[round(w * 1e3, 3) for w in lwalls]} ms); "
          f"card: {card}", flush=True)

    # f64 on the <2,2> bucket.
    two = next((f, xb, pb) for f, xb, pb in fleets if f.system.n_vars == 2)
    xb, pb = two[1][:F64_BUCKET_LANES], tuple(p[:F64_BUCKET_LANES] for p in two[2])
    from ezpz_tpu_torch.batch import BatchSolver
    from ezpz_tpu_torch.config import Config

    f64 = fleet_solver(two[0].system, "f64")
    out = f64.solve(xb, pb)
    ref = BatchSolver(two[0].system, Config(), batch_params=True, precision="f64").solve(xb, pb)
    same_batch(f"phase9a f64 <2,2> x{F64_BUCKET_LANES} against BatchSolver", out, ref)
    gate("phase9a f64 <2,2>", [(f64, xb, pb)], [out])


def cg_problem(lines):
    """(compiled f64 system, x0) of the ``lines``-line coupled chain."""
    from ezpz_tpu_torch.benches import coupled_bench
    from ezpz_tpu_torch.models.compiled import compile_system

    cons, x0 = coupled_bench.build_problem(lines)
    return compile_system(cons, len(x0)), x0


def counted_cg_solve(system, x0s):
    """``solve_lm_cg`` with its LM trips (Jacobian passes), CG calls and CG
    trips (matvecs less one per call, for r0) counted."""
    from ezpz_tpu_torch import solver as TS
    from ezpz_tpu_torch.models import compiled as TC

    counts = dict(lm_trips=0, cg_calls=0, matvecs=0)
    saved = (TC.CompiledSystem.jacobian_factors, TC.CompiledSystem.jtj_matvec, TS._cg)

    def factors(self, *a, **k):
        counts["lm_trips"] += 1
        return saved[0](self, *a, **k)

    def matvec(self, *a, **k):
        counts["matvecs"] += 1
        return saved[1](self, *a, **k)

    def cg(*a, **k):
        counts["cg_calls"] += 1
        return saved[2](*a, **k)

    TC.CompiledSystem.jacobian_factors, TC.CompiledSystem.jtj_matvec, TS._cg = (
        factors, matvec, cg)
    try:
        res = TS.solve_lm_cg(system, x0s, *LM_CFG)
    finally:
        TC.CompiledSystem.jacobian_factors, TC.CompiledSystem.jtj_matvec, TS._cg = saved
    counts["cg_trips"] = counts["matvecs"] - counts["cg_calls"]
    return res, counts


def phase9b(dev, card):
    """The matrix-free LM on CG_COPIES copies of the CG_LINES-line chain,
    against dense ``solve_lm``; one copy of the 600-line chain stops
    unconverged as the JAX package's does. Returns the chain's inputs for
    phase 9c."""
    import numpy as np
    import torch

    from ezpz_tpu_torch import solver as TS

    system, x0 = cg_problem(CG_LINES)
    n = len(x0)
    noise = np.random.default_rng(9).normal(0.0, CG_SIGMA, (CG_COPIES + REPS, n))
    x0s = torch.as_tensor(x0 + noise[:CG_COPIES], device=dev)
    TS.solve_lm_cg(system, x0s[:2], *LM_CFG)  # warm-up

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, counts = counted_cg_solve(system, x0s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cg_peak = torch.cuda.max_memory_allocated()
    r, _deg = system.residual_and_flags(res.x)
    rmax = float(r.abs().max())
    conv = bool(res.converged.all())
    # One live check per trip and one that ends each loop.
    syncs = counts["lm_trips"] + 1 + counts["cg_trips"] + counts["cg_calls"]
    print(f"phase9b solve_lm_cg f64: {CG_COPIES} copies of the {CG_LINES}-line chain "
          f"({n} variables): converged={conv} f64_residual_max={rmax!r} iterations "
          f"{int(res.iterations.min())}-{int(res.iterations.max())}; {wall * 1e3!r} ms "
          f"(host clock, first run); LM trips {counts['lm_trips']}, CG calls "
          f"{counts['cg_calls']}, CG trips {counts['cg_trips']}, host syncs of the loops "
          f"{syncs}; peak device memory "
          f"{cg_peak!r} bytes; card: {card}", flush=True)
    if not (conv and rmax <= 1e-8):
        raise SystemExit("chip_smoke: phase9b matrix-free LM failed its gate")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dense = TS.solve_lm(system, x0s, *LM_CFG)
    torch.cuda.synchronize()
    dense_first = time.perf_counter() - t0
    dense_peak = torch.cuda.max_memory_allocated()
    ok = (torch.equal(dense.converged, res.converged)
          and torch.equal(dense.iterations, res.iterations))
    dx = float((dense.x - res.x).abs().max())
    print(f"phase9b dense solve_lm: flags and iterations equal={ok} max|dx|={dx!r} "
          f"(tolerance {CG_X_TOL!r}); {dense_first * 1e3!r} ms (host clock, first run); "
          f"peak device memory {dense_peak!r} bytes, {dense_peak / cg_peak!r}x the "
          f"matrix-free solve's", flush=True)
    if not ok or dx > CG_X_TOL:
        raise SystemExit("chip_smoke: phase9b matrix-free LM differs from dense LM")
    del dense

    walls = {}
    for label, fn in (("solve_lm_cg", TS.solve_lm_cg), ("solve_lm", TS.solve_lm)):
        reps = []
        for rep in range(REPS):
            xs = x0s + torch.as_tensor(noise[CG_COPIES + rep], device=dev) * 1e-3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(system, xs, *LM_CFG)
            torch.cuda.synchronize()
            reps.append(time.perf_counter() - t0)
        walls[label] = sorted(reps)[REPS // 2]
        print(f"phase9b {label}: median {walls[label] * 1e3!r} ms per {CG_COPIES}-copy "
              f"solve (host clock, fresh inputs, reps "
              f"{[round(w * 1e3, 3) for w in reps]} ms); card: {card}", flush=True)
    print(f"phase9b profiled solve_lm_cg: "
          f"{profiled(lambda: TS.solve_lm_cg(system, x0s, *LM_CFG))}", flush=True)

    big, bx0 = cg_problem(CG_UNCONVERGED_LINES)
    t0 = time.perf_counter()
    one, big_counts = counted_cg_solve(big, torch.as_tensor(bx0, device=dev)[None])
    torch.cuda.synchronize()
    big_wall = time.perf_counter() - t0
    br = float(one.residual.abs().max())
    print(f"phase9b solve_lm_cg on the {CG_UNCONVERGED_LINES}-line chain, one copy: "
          f"converged={bool(one.converged[0])} iterations={int(one.iterations[0])} "
          f"max|r|={br!r}; LM trips {big_counts['lm_trips']}, CG trips "
          f"{big_counts['cg_trips']}; {big_wall * 1e3!r} ms; card: {card}", flush=True)
    if bool(one.converged[0]) or int(one.iterations[0]) != LM_CFG[0]:
        raise SystemExit("chip_smoke: the 600-line chain did not stop unconverged at the "
                         "LM budget as the JAX package's does")
    return system, x0s


def phase9c(system, x0s, card):
    """Gauss-Newton on the same copies: every lane converged (f64 residual
    <= 1e-8); flags and iterations equal to the CPU's on CG_CPU_COPIES."""
    import torch

    from ezpz_tpu_torch import solver as TS

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gn = TS.solve_gauss_newton(system, x0s, *LM_CFG)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r, _deg = system.residual_and_flags(gn.x)
    rmax = float(r.abs().max())
    k = CG_CPU_COPIES
    cpu = TS.solve_gauss_newton(system, x0s[:k].cpu(), *LM_CFG)
    ok = (torch.equal(gn.converged[:k].cpu(), cpu.converged)
          and torch.equal(gn.iterations[:k].cpu(), cpu.iterations))
    dx = float((gn.x[:k].cpu() - cpu.x).abs().max())
    print(f"phase9c solve_gauss_newton f64: {x0s.shape[0]} copies converged="
          f"{bool(gn.converged.all())} f64_residual_max={rmax!r} iterations "
          f"{int(gn.iterations.min())}-{int(gn.iterations.max())}, {wall * 1e3!r} ms "
          f"(host clock); against the CPU on {k} copies: flags and iterations "
          f"equal={ok} max|dx|={dx!r}; card: {card}", flush=True)
    if not (bool(gn.converged.all()) and rmax <= 1e-8 and ok):
        raise SystemExit("chip_smoke: phase9c Gauss-Newton failed")


def phase9d(dev, card):
    """The five residual fields on the card against the CPU's."""
    from ezpz_tpu_torch import residual_viz as rv

    for name, args in VIZ_ARGS.items():
        render = getattr(rv, f"render_{name}")
        t0 = time.perf_counter()
        img = render(*args, *VIZ_VIEW, device=dev)
        ms = (time.perf_counter() - t0) * 1e3
        ref = render(*args, *VIZ_VIEW, device="cpu")
        equal = bool((img == ref).all())
        score = rv.compare_images(img, ref)
        print(f"phase9d {name}: pixel-equal={equal} score={score!r}, {ms!r} ms on the "
              f"card (host clock, first call); card: {card}", flush=True)
        if not (equal or score >= 0.99):
            raise SystemExit(f"chip_smoke: residual field {name} differs from the CPU's")


def phase9e(card):
    """The three examples on the card, their lines checked."""
    import contextlib
    import io

    from ezpz_tpu_torch.examples import basic, parser, scale

    for name, module in (("basic", basic), ("parser", parser), ("scale", scale)):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            module.main([])
        secs = time.perf_counter() - t0
        out = buf.getvalue()
        missing = [line for line in EXAMPLE_LINES[name] if line not in out]
        print(f"phase9e example {name} on the card ({secs!r} s): "
              + " | ".join(out.strip().splitlines()), flush=True)
        if missing:
            raise SystemExit(f"chip_smoke: example {name} did not print {missing}")


def phase9(dev, card):
    t_start = time.perf_counter()
    times = []
    phase9a(dev, card)
    times.append(time.perf_counter() - t_start)
    system, x0s = phase9b(dev, card)
    times.append(time.perf_counter() - t_start - sum(times))
    phase9c(system, x0s, card)
    times.append(time.perf_counter() - t_start - sum(times))
    phase9d(dev, card)
    times.append(time.perf_counter() - t_start - sum(times))
    phase9e(card)
    times.append(time.perf_counter() - t_start - sum(times))
    print(f"phase9 ok: {sum(times):.1f} s (a, b, c, d, e: "
          f"{[round(t, 1) for t in times]} s)", flush=True)


# Phase 10: the collective slice.
# The coupled chain of SHARDED_r03.json: 25,000 lines, 100,000 variables,
# 2,500 parts (P, m, kb, n_b, band_bw below), banded boundary, mixed.
SHARDED_LINES = 25_000
SHARDED_STRUCTURE = (2500, 36, 19992, 11)  # n_parts, n_interior, n_boundary, bw
# In mixed precision this chain's LM trips are decided by f32 rounding:
# its boundary's softest modes lie near f32's resolution, so the f32
# solves of a boundary band are backward stable (~4e-8) yet part by ~2%
# (phase10a prints both; the condition number is at least their ratio).
# JAX's CPU run reaches 9.94e-9 at trip 32 of the default 35; the card's
# runs, banded and (the witness) dense, get this budget, and their max|r|
# at the default budget's end is printed; the f64 solve (exact steps) runs
# at the default budget.
SHARDED_MAX_ITERATIONS = 60
# The mixed banded run's trips and max|r| after trip 35 as recorded on one
# NVIDIA H100 80GB HBM3 (torch 2.11.0+cu128): the banded kernel is bit-equal
# to its plain version, so a kernel change that keeps that leaves them as
# they are (printed beside the run's own).
SHARDED_TRIPS, SHARDED_TRIP35_MAX_R = 39, 2.2618739770052798e-08
# The hub assembly of SHARDED_r03.json: 100,004 variables, 2,501 parts.
HUB_LINES, HUB_CLUSTER = 25_001, 10
SHARDED_REPS = 3
# Several ranks on one card (gloo).
GLOO_RANKS = 4
GLOO_SCHUR_POINTS = 256 * GLOO_RANKS
GLOO_CHAIN_LINES = 2_500
LAUNCH_TIMEOUT = 300


def sharded_report(label, rep, cons, n_vars, dev, card):
    """Gate one rank-0 report of ``dryrun.run_cases``: converged, every
    constraint satisfied, the f64 residual recomputed on the card <= 1e-8,
    every rank's outcome equal to rank 0's and every rep's to the first
    (bit-equal from run to run); print its numbers. Returns the median ms
    of the timed reps."""
    import torch

    from ezpz_tpu_torch.models.compiled import compile_system

    out, counts = rep["out"], rep["counts"]
    history = rep["history"]
    r = compile_system(cons, n_vars).residual(torch.as_tensor(out["x"], device=dev)[None])
    rmax = float(r.abs().max())
    timed_ms = rep["ms"][1:] or rep["ms"]  # a single rep: its first solve
    ms = sorted(timed_ms)[len(timed_ms) // 2]
    print(f"{label}: {n_vars} variables, {out['n_parts']} parts over {out['n_devices']} "
          f"rank(s), n_boundary={out['n_boundary']} n_interior={out['n_interior']}; "
          f"converged={out['converged']} satisfied={bool(out['satisfied'].all())} "
          f"iterations={out['iterations']} f64_residual_max={rmax!r}; ranks agree "
          f"{rep['agree']}, reps bit-equal {rep['reps_equal']}; {ms!r} ms per solve (host "
          f"clock, median of {len(timed_ms)}: {[round(t, 3) for t in timed_ms]}; first "
          f"{rep['ms'][0]!r} ms; set-up {rep['setup_s']:.1f} s); per solve: "
          f"{counts['collectives']} collectives, {counts['bytes']} bytes, "
          f"{counts['host_syncs']} host syncs, {counts['lm_trips']} LM trips, "
          f"{counts['cg_trips']} CG trips, banded_spd calls {rep['banded_launches']}; "
          f"peak device memory {rep['peak_bytes']!r} bytes (rank 0); max|r| after trips "
          f"1, 2, 3, 12, 20, 32, 35 and the last: "
          f"{[history[k - 1] for k in (1, 2, 3, 12, 20, 32, 35) if k <= len(history)]} "
          f"{history[-1:]}; card: {card}", flush=True)
    if rep.get("profile"):
        prof = rep["profile"]
        print(f"{label} profiled solve: {prof['launches']} kernel launches, device busy "
              f"{prof['device_ms']!r} ms of {prof['wall_ms']!r} ms wall (profiled), idle "
              f"share {1 - prof['device_ms'] / prof['wall_ms']!r}; top kernels (name, "
              f"calls, device ms): {prof['top']}", flush=True)
    if not (out["converged"] and out["satisfied"].all() and rmax <= 1e-8
            and rep["agree"] and rep["reps_equal"]):
        raise SystemExit(f"chip_smoke: {label} failed its gate")
    return ms


def phase10ab(dev, card):
    """10a and 10b over an NCCL group of every visible card: the sharded
    100,000-variable chain (``ShardedBlockSchurSolver``, banded, mixed) and
    the 100,004-variable hub (CG), with the chain in f64 and, as the
    witness of what rounding costs in trips, with the dense boundary.
    Returns the chain's banded launches (mixed and f64, every one on the
    lanes route) and the first boundary solve's (band, rhs) of each."""
    import torch

    from ezpz_tpu_torch import dryrun, fixtures
    from ezpz_tpu_torch.benches import coupled_bench
    from ezpz_tpu_torch.parallel import dist

    from ezpz_tpu_torch.config import Config

    n_cards = torch.cuda.device_count()
    chain, x0 = coupled_bench.build_problem(SHARDED_LINES)
    hub, hub_x0, hub_parts = fixtures.coupled_hub(HUB_LINES, HUB_CLUSTER)
    cases = [
        dict(solver="hier", constraints=chain, n_vars=len(x0),
             kwargs=dict(boundary_solver="banded", precision="mixed",
                         config=Config(max_iterations=SHARDED_MAX_ITERATIONS)),
             steps=[("solve", (x0,))], reps=1 + SHARDED_REPS, capture=True, profile=True),
        dict(solver="hier", constraints=chain, n_vars=len(x0),
             kwargs=dict(boundary_solver="banded", precision="f64"),
             steps=[("solve", (x0,))], reps=1 + SHARDED_REPS, capture=True),
        dict(solver="hier", constraints=chain, n_vars=len(x0),
             kwargs=dict(boundary_solver="dense", precision="mixed",
                         config=Config(max_iterations=SHARDED_MAX_ITERATIONS)),
             steps=[("solve", (x0,))], reps=1),
        dict(solver="hier", constraints=hub, n_vars=len(hub_x0),
             kwargs=dict(part_of_var=hub_parts, boundary_solver="cg", precision="mixed"),
             steps=[("solve", (hub_x0,))], reps=2),
    ]
    t0 = time.perf_counter()
    (rep_a,), (rep_f64,), (rep_dense,), (rep_b,) = dist.run_ranks(
        dryrun.run_cases, n_cards, "nccl", None, cases)
    print(f"phase10ab: {n_cards} NCCL rank(s), {time.perf_counter() - t0:.1f} s with the "
          f"ranks' spawn", flush=True)
    sharded_report(f"phase10a sharded chain (banded, mixed, {SHARDED_MAX_ITERATIONS}-trip "
                   f"budget)", rep_a, chain, len(x0), dev, card)
    sharded_report("phase10a sharded chain (banded, f64)", rep_f64, chain, len(x0), dev, card)
    sharded_report(f"phase10a witness: sharded chain (dense, mixed, "
                   f"{SHARDED_MAX_ITERATIONS}-trip budget)", rep_dense, chain, len(x0), dev,
                   card)
    hist = rep_a["history"]
    print(f"phase10a mixed banded trajectory as recorded ({SHARDED_TRIPS} trips, "
          f"{SHARDED_TRIP35_MAX_R!r} after trip 35): "
          f"{len(hist) == SHARDED_TRIPS and hist[34] == SHARDED_TRIP35_MAX_R} "
          f"({len(hist)} trips, {hist[34] if len(hist) >= 35 else None!r} after trip 35)",
          flush=True)
    if rep_f64["banded_launches"] == 0:
        raise SystemExit("chip_smoke: phase10a f64 did not launch the banded kernel")
    band, rhs = rep_a["captured"]
    out = rep_a["out"]
    structure = (out["n_parts"], out["n_interior"], out["n_boundary"], band.shape[2] - 1)
    if structure != SHARDED_STRUCTURE or rep_a["banded_launches"] == 0:
        raise SystemExit(f"chip_smoke: phase10a structure {structure} is not "
                         f"SHARDED_r03's {SHARDED_STRUCTURE}, or the banded kernel "
                         f"was not launched")
    sharded_report("phase10b hub (cg, mixed)", rep_b, hub, len(hub_x0), dev, card)
    if rep_b["counts"]["cg_trips"] == 0:
        raise SystemExit("chip_smoke: phase10b ran no CG trip")
    bands = [tuple(torch.as_tensor(t, device=dev) for t in rep["captured"])
             for rep in (rep_a, rep_f64)]
    routes = [rep["banded_routes"] for rep in (rep_a, rep_f64)]
    print(f"phase10a banded launches by route (mixed, f64): {routes}", flush=True)
    if any(r["lanes"] != sum(r.values()) for r in routes):
        raise SystemExit("chip_smoke: phase10a launched a banded route other than lanes")
    return sum(r["lanes"] for r in routes), bands


def phase10c(dev, card):
    """Several ranks on one card: GLOO_RANKS gloo ranks on cuda:0 against
    the same solvers as a world of one on the card (no group in this
    process): flags and iterations equal, x within X_TOL."""
    from ezpz_tpu_torch import dryrun
    from ezpz_tpu_torch.benches import coupled_bench
    from ezpz_tpu_torch.fixtures import horizontal_chain
    from ezpz_tpu_torch.parallel import ShardedBlockSchurSolver, ShardedSchurSolver, dist

    schur_cons, schur_x0 = horizontal_chain(GLOO_SCHUR_POINTS)
    chain, chain_x0 = coupled_bench.build_problem(GLOO_CHAIN_LINES)
    runs = [
        ("ShardedSchurSolver dense f64", ShardedSchurSolver, "schur", schur_cons,
         schur_x0, dict(precision="f64", boundary_solver="dense")),
        ("ShardedBlockSchurSolver banded mixed", ShardedBlockSchurSolver, "hier", chain,
         chain_x0, dict(boundary_solver="banded", precision="mixed")),
    ]
    cases = [dict(solver=kind, constraints=cons, n_vars=len(x), kwargs=kw,
                  steps=[("solve", (x,))], reps=2)
             for _l, _c, kind, cons, x, kw in runs]
    t0 = time.perf_counter()
    reports = dist.run_ranks(dryrun.run_cases, GLOO_RANKS, "gloo",
                             [str(dev)] * GLOO_RANKS, cases)
    print(f"phase10c: {GLOO_RANKS} gloo ranks on {dev}, "
          f"{time.perf_counter() - t0:.1f} s with the ranks' spawn", flush=True)
    for (label, cls, _k, cons, x, kw), (rep,) in zip(runs, reports):
        one = cls(cons, len(x), device=dev, **kw).solve(x)
        out = rep["out"]
        same = all(out[k] == one[k] for k in ("converged", "iterations")) and all(
            (out[k] == one[k]).all() for k in ("satisfied", "degenerate"))
        err = float(abs(out["x"] - one["x"]).max())
        print(f"phase10c {label}: {GLOO_RANKS} ranks n_boundary={out['n_boundary']} "
              f"iterations={out['iterations']} converged={out['converged']}, world of one "
              f"n_boundary={one['n_boundary']} iterations={one['iterations']}: flags and "
              f"iterations equal {same}, max|dx|={err!r}; ranks agree {rep['agree']}, reps "
              f"bit-equal {rep['reps_equal']}; {rep['counts']['collectives']} collectives "
              f"per solve; {rep['ms'][-1]!r} ms; card: {card}", flush=True)
        if not (same and err <= X_TOL and rep["agree"] and rep["reps_equal"]
                and out["converged"]):
            raise SystemExit(f"chip_smoke: phase10c {label} differs from its world of one")


def phase10d(card):
    """The multi-chip dry run over every visible card (NCCL), and the
    launcher's schur and fleet demos as one process."""
    import torch

    from ezpz_tpu_torch import dryrun

    n_cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    summary = dryrun.dryrun_multichip(n_cards)
    print(f"phase10d dryrun_multichip({n_cards}): {summary} "
          f"({time.perf_counter() - t0:.1f} s); card: {card}", flush=True)
    if summary["fused_launches_rank0"] == 0:
        raise SystemExit("chip_smoke: the dry run's fused path launched no kernel")
    for demo, want in (("schur", "converged=True"), ("fleet", "sketches/sec")):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ezpz_tpu_torch.launch", "--demo", demo],
                              capture_output=True, text=True, cwd=HERE,
                              timeout=LAUNCH_TIMEOUT)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(("mesh:", demo))]
        print(f"phase10d launch --demo {demo} ({time.perf_counter() - t0:.1f} s, exit "
              f"{proc.returncode}): " + " | ".join(lines), flush=True)
        if proc.returncode != 0 or not any(want in ln for ln in lines):
            raise SystemExit(f"chip_smoke: launch --demo {demo} failed:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")


def phase10_band(bands, card):
    """The banded kernel alone at 10a's operating point (B = 1, n_b =
    19,992): the mixed run's first band in f32 and the f64 run's in f64,
    each against its plain version on the card at full size and against
    the dense library solve, the warp kernel forced beside the lane
    kernel's route (``phase8_kernel``). Then whether the f32 band
    cast to f64 still has a Cholesky factor (its softest mode against f32
    rounding), and how the plain version on the host CPU parts from the
    kernel: PyTorch's CPU sqrt is not correctly rounded (counted against
    numpy's on a million inputs; the card's is), and the band's condition
    amplifies a last-bit difference."""
    import numpy as np
    import torch

    from ezpz_tpu_torch.ops import banded

    (band32, rhs32), (band64, rhs64) = bands
    phase8_kernel(band32, rhs32, card, label="phase10a", dtypes=(torch.float32,),
                  forced=("warp",))
    phase8_kernel(band64, rhs64, card, label="phase10a", dtypes=(torch.float64,),
                  forced=("warp",))
    _x, fail64 = banded.banded_spd_solve(band32.double(), rhs32.double())
    x, _fail = banded.banded_spd_solve(band32, rhs32)
    t0 = time.perf_counter()
    x_cpu, _fail = banded.banded_spd_reference(band32.cpu(), rhs32.cpu())
    cpu_s = time.perf_counter() - t0
    vals = np.random.default_rng(10).uniform(1e-3, 10.0, 1 << 20)
    wrong = {}
    for dtype in (np.float32, np.float64):
        v = vals.astype(dtype)
        want = np.sqrt(v)
        wrong[dtype.__name__] = (
            int((torch.as_tensor(v).sqrt().numpy() != want).sum()),
            int((torch.as_tensor(v, device=band32.device).sqrt().cpu().numpy() != want).sum()))
    print(f"phase10a band: the f32 band cast to f64 has a Cholesky factor: "
          f"{not bool(fail64.any())}; plain version on the host CPU ({cpu_s:.1f} s) against "
          f"the kernel: max|dx|={float((x_cpu - x.cpu()).abs().max())!r}; torch.sqrt results "
          f"not correctly rounded of {1 << 20} (CPU, card): {wrong}; card: {card}", flush=True)


def phase10(dev, card):
    """The collective slice on the card. Returns the lane kernel's
    launches on the sharded chain's runs."""
    t_start = time.perf_counter()
    launches, bands = phase10ab(dev, card)
    t_ab = time.perf_counter() - t_start
    phase10_band(bands, card)
    t_kernel = time.perf_counter() - t_start - t_ab
    phase10c(dev, card)
    t_c = time.perf_counter() - t_start - t_ab - t_kernel
    phase10d(card)
    t_d = time.perf_counter() - t_start - t_ab - t_kernel - t_c
    print(f"phase10 ok: {time.perf_counter() - t_start:.1f} s (ab, kernel, c, d: "
          f"{[round(t, 1) for t in (t_ab, t_kernel, t_c, t_d)]} s)", flush=True)
    return launches


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

    t_main = time.perf_counter()
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
    torch.set_float32_matmul_precision("highest")

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
    band_tier = phase3d(dev, card)
    jacobian = phase3j(dev, card)
    fused = phase4(dev, card)
    coarse = phase5(dev, card)
    full, api_us = phase6(dev, card)
    phase7(dev, card, full, api_us)
    band = phase8(dev, card)
    lanes = phase8_lanes(dev, card)
    wide, dynamic, general, warp = phase8w(dev, card)
    phase9(dev, card)
    launches = phase10(dev, card)
    # The warp kernel's record: phase 8w's main-path run at bw = 27, its
    # launches with phase 3d's rect_grid(8,8) run's. The lane kernel's:
    # phase 8l's band, the launches of the four main-path runs it takes
    # (phase 3d's rect_chain(64), 8, 8l and 10a). The wide routes (phase
    # 8w) are records of their own. The Jacobian kernel's launches: phase
    # 3d's two main-path runs, one a LM trip.
    warp = dict(warp, launches=warp["launches"] + band_tier["warp"])
    jacobian = dict(jacobian, launches=band_tier["lm_jacobian"])
    lanes = dict(lanes, launches=lanes["launches"] + band["launches"] + launches
                 + band_tier["lanes"])
    kernels = []
    for name, rec, source, replaces in (
            ("fused_fleet", fused, "fused_fleet", "ezpz_tpu/ops/pallas_fleet.py:898"),
            ("coarse_fleet", coarse, "coarse_fleet", "ezpz_tpu/ops/pallas_fleet.py:598"),
            ("banded_spd", warp, "banded_spd", "ezpz_tpu/ops/banded.py:37"),
            ("banded_spd_lanes", lanes, "banded_lanes", "ezpz_tpu/ops/banded.py:37"),
            ("banded_spd_wide", wide, "banded_dynamic", "ezpz_tpu/ops/banded.py:37"),
            ("banded_spd_dynamic", dynamic, "banded_dynamic", "ezpz_tpu/ops/banded.py:37"),
            ("banded_spd_general", general, "banded_spd", "ezpz_tpu/ops/banded.py:37"),
            ("lm_jacobian", jacobian, "lm_jacobian", None)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"ezpz_tpu_torch/csrc/{source}.cu",
            "replaces": replaces,
            "launches": rec["launches"],
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"),
        })
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_main:.1f} s", flush=True)
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
