"""Drive the multi-device paths over spawned ranks.

``dryrun_multichip(n_devices, device=None)`` is the counterpart of
``__graft_entry__.dryrun_multichip``: over ``n_devices`` ranks (NCCL, one
per card, by default; gloo ranks on ``device`` when one is named, the CPU
or one shared card) it runs one solve of each multi-device path and checks
what the JAX dry run asserts:

1. ``FleetSolver`` in f64, each rank a slice of the batch;
1b. ``FleetSolver(precision="mixed", pallas_fused=True)`` at 1024 lanes per
    rank: the fused path (the kernel on a card);
2. ``ShardedSchurSolver`` on chains coupled across the ranks;
3. ``ShardedBlockSchurSolver`` with the CG boundary;
3b. the same with the banded boundary.

``run_cases(cases)`` runs a list of sharded solves on every rank of a
group and reports rank 0's outcomes with their counters: the tests hold
them against the JAX package's, and ``chip_smoke.py`` times them. Both run
inside ``dist.run_ranks``.

    python -m ezpz_tpu_torch.dryrun 8 --cpu    # 8 gloo ranks on the CPU
    python -m ezpz_tpu_torch.dryrun 4          # 4 cards, NCCL
"""

from __future__ import annotations

import argparse
import hashlib
import pickle
import sys
import time

import numpy as np
import torch

from .config import Config
from .constraints import Constraint
from .datatypes import DatumLineSegment, DatumPoint
from .models.compiled import compile_system
from .parallel import dist


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _digest(out) -> torch.Tensor:
    """Four words of a hash of a step's result."""
    digest = hashlib.sha256(pickle.dumps(out)).digest()
    return torch.as_tensor(np.frombuffer(digest, dtype=np.int64).copy())


def _make_solver(case: dict, group):
    from .parallel import ShardedBlockSchurSolver, ShardedSchurSolver

    cls = {"schur": ShardedSchurSolver, "hier": ShardedBlockSchurSolver}[case["solver"]]
    return cls(case["constraints"], case["n_vars"], group=group, **case.get("kwargs", {}))


def _partial_checkpoint(solver, x0, path, limit):
    """Run the first ``limit`` iterations by hand and save them as
    ``solve_checkpointed`` would (a solve preempted after one segment)."""
    from .checkpoint import save_state

    c = solver.config
    x_i0, x_b0 = solver._scatter_x(x0)
    deg0 = np.zeros((solver.layout.n_devices, solver.n_cons_max + 1), dtype=bool)
    x_i, x_b, its, _conv, deg, _sat, lam, it, finished = solver._run_segment(
        x_i0, x_b0, c.initial_lambda, 0, deg0, limit)
    if solver.comm.rank == 0:
        save_state(path, solver.fingerprint(x0), x_i, x_b, lam, it, deg)
    solver.comm.barrier()
    return dict(it=it, iterations=its, finished=finished)


def _run_step(solver, method, args, capture):
    """One call on the solver; returns its result and, when ``capture``,
    the first banded boundary solve's (band, rhs) in numpy."""
    from .parallel import hier

    if method == "partial_checkpoint":
        return _partial_checkpoint(solver, *args), None
    if not capture:
        return getattr(solver, method)(*args), None
    seen = []

    def spy(band, rhs):
        if not seen:
            seen.append((band.cpu().numpy(), rhs.cpu().numpy()))
        return real_solve(band, rhs)

    real_solve = hier.banded_spd_solve
    hier.banded_spd_solve = spy
    try:
        return getattr(solver, method)(*args), (seen[0] if seen else None)
    finally:
        hier.banded_spd_solve = real_solve


def _profiled(fn, dev) -> dict:
    """``fn()`` once under ``torch.profiler`` (CPU and CUDA activity):
    kernel launches, device busy ms (the kernels' summed device time), wall
    ms, and the ten kernels with the most device time (name, calls, ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    launches, kernels = 0, []
    for e in prof.key_averages():
        if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx"):
            launches += e.count
        if e.device_type == DeviceType.CUDA:
            kernels.append((e.key, e.count, getattr(e, "self_device_time_total", 0.0) / 1e3))
    kernels.sort(key=lambda k: -k[2])
    return dict(launches=launches, device_ms=sum(k[2] for k in kernels), wall_ms=wall,
                top=kernels[:10])


def run_cases(cases):
    """Run every case on this rank (call it on every rank of the world,
    inside ``dist.run_ranks``); returns per case, on rank 0, the list of
    its steps' reports.

    A case is a dict: ``solver`` ("schur" or "hier"), ``constraints``,
    ``n_vars``, ``kwargs`` (the constructor's, without ``group``), ``ranks``
    (use the first k ranks as the solver's group; default all), ``steps``
    (a list of ``(method, args)``: ``solve`` (x0), ``solve_checkpointed``
    (x0, path, every), ``partial_checkpoint`` (x0, path, limit)), ``reps``
    (time the first step this many times; default 1), ``capture`` (keep
    the first banded boundary's band and rhs) and ``profile`` (run the
    first step once more under ``torch.profiler``). A step's report: ``out``
    (its result), ``counts`` (the solver's counters), ``ms`` (host clock
    per call, synchronised), ``agree`` (every rank's outcome equal to rank
    0's, by a hash), ``reps_equal`` (every rep's outcome equal to the
    first's), ``history`` (the two-level solver's max|r| per trip),
    ``banded_launches`` (in the last rep) and ``peak_bytes`` (on
    a card: peak device memory of the step), ``captured``, ``setup_s`` (the
    solver's construction) and ``profile`` (``_profiled``'s summary)."""
    from .ops import banded_spd

    reports = []
    for case in cases:
        ranks = case.get("ranks")
        group = None
        if ranks is not None and dist.initialized():
            group = torch.distributed.new_group(list(range(ranks)))
        if ranks is not None and dist.initialized() and torch.distributed.get_rank() >= ranks:
            reports.append(None)
            continue
        t0 = time.perf_counter()
        solver = _make_solver(case, group)
        setup_s = time.perf_counter() - t0
        dev = solver.device
        steps = []
        for k, (method, args) in enumerate(case.get("steps", [("solve", ())])):
            reps = case.get("reps", 1) if k == 0 else 1
            captured = None
            ms, digests = [], []
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            for rep in range(reps):
                banded_spd.LAUNCHES = 0
                _sync(dev)
                t1 = time.perf_counter()
                out, cap = _run_step(solver, method, args,
                                     case.get("capture", False) and rep == 0)
                _sync(dev)
                ms.append((time.perf_counter() - t1) * 1e3)
                captured = captured if cap is None else cap
                digests.append(_digest(out))
            report = dict(out=out, counts=solver.counts(), ms=ms,
                          banded_launches=banded_spd.LAUNCHES,
                          peak_bytes=(torch.cuda.max_memory_allocated(dev)
                                      if dev.type == "cuda" else None),
                          captured=captured, setup_s=setup_s,
                          history=list(getattr(solver, "history", [])),
                          reps_equal=all(bool((d == digests[0]).all()) for d in digests))
            rows = solver.comm.gather(digests[-1].to(dev))
            report["agree"] = bool((rows == rows[0]).all())
            if case.get("profile") and k == 0:
                report["profile"] = _profiled(lambda: _run_step(solver, method, args, False),
                                              dev)
            steps.append(report)
        reports.append(steps)
    return reports


# -- the multi-chip dry run -----------------------------------------------------


def _fixture_system():
    """One vertical-line block of the massive_parallel_system topology."""
    p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    cs = [
        Constraint.Vertical(DatumLineSegment(p, q)),
        Constraint.Fixed(p.x_id, 0.0),
        Constraint.Fixed(p.y_id, 0.0),
        Constraint.Fixed(q.y_id, 4.0),
    ]
    return cs, np.array([0.3, -0.2, 0.8, 3.1])


def coupled_chains(n_blocks: int, pts_per_block: int = 3):
    """``n_blocks`` horizontal chains of unit links, each pinned, the
    last point's y of each chain equal to the next chain's first: the JAX
    dry run's coupled system. Returns (constraints, x0)."""
    constraints = []
    n_vars = n_blocks * pts_per_block * 2
    x0 = np.zeros(n_vars)
    for b in range(n_blocks):
        base = b * pts_per_block * 2
        pts = [DatumPoint(base + 2 * i, base + 2 * i + 1) for i in range(pts_per_block)]
        constraints.append(Constraint.Fixed(pts[0].x_id, float(b)))
        constraints.append(Constraint.Fixed(pts[0].y_id, 0.0))
        for i in range(pts_per_block - 1):
            constraints.append(Constraint.Distance(pts[i], pts[i + 1], 1.0))
            constraints.append(Constraint.Horizontal(DatumLineSegment(pts[i], pts[i + 1])))
        x0[base: base + 2 * pts_per_block: 2] = float(b) + np.arange(pts_per_block)
        x0[base + 1: base + 2 * pts_per_block: 2] = 0.1
    for b in range(n_blocks - 1):
        last_y = b * pts_per_block * 2 + (pts_per_block - 1) * 2 + 1
        next_first_y = (b + 1) * pts_per_block * 2 + 1
        constraints.append(Constraint.ScalarEqual(last_y, next_first_y))
    return constraints, x0


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_rank() -> dict:
    """The dry run's steps on this rank (every rank of the world runs
    them); returns a summary, the same on every rank."""
    from .ops import fused_fleet
    from .parallel import FleetSolver, ShardedBlockSchurSolver, ShardedSchurSolver

    comm = dist.Comm()
    dev, n = comm.device, comm.size
    summary = {"ranks": n, "device": str(dev)}

    # 1. A batch of independent sketches, each rank its slice.
    cs, x0 = _fixture_system()
    system = compile_system(cs, n_vars=len(x0))
    fleet = FleetSolver(system, devices=[dev], config=Config())
    res = fleet.solve(np.tile(x0, (4, 1)))
    done = comm.psum(torch.stack([res.converged.sum(), torch.tensor(4, device=res.x.device)])
                     .to(torch.float64).to(dev))
    _check(bool(done[0] == done[1]), f"fleet f64: {done.tolist()} converged")
    summary["fleet_f64_sketches"] = int(done[1])

    # 1b. The fused path, 1024 lanes per rank.
    Bf = 1024
    pars = tuple(np.tile(b.par, (Bf, 1, 1)) for b in system.blocks)
    fused = FleetSolver(system, devices=[dev], config=Config(), batch_params=True,
                        precision="mixed", pallas_fused=True)
    _check(fused._local.kernel_ok, "the fused kernel's gate refused the fixture")
    before = fused_fleet.LAUNCHES
    resf = fused.solve(np.tile(x0, (Bf, 1)), pars)
    launched = fused_fleet.LAUNCHES - before
    _check(dev.type != "cuda" or launched > 0, "the fused kernel was not launched")
    good = comm.psum(torch.stack([resf.converged.sum(), resf.satisfied.all(dim=1).sum()])
                     .to(torch.float64).to(dev))
    _check(bool((good == Bf * n).all()), f"fused fleet: {good.tolist()} of {Bf * n}")
    summary["fused_sketches"] = Bf * n
    summary["fused_launches_rank0"] = launched

    # 2. One system sharded over the ranks (dense Schur boundary).
    constraints, x0_big = coupled_chains(n)
    n_vars = len(x0_big)
    out = ShardedSchurSolver(constraints, n_vars, config=Config()).solve(x0_big)
    _check(out["converged"] and out["satisfied"].all(), f"sharded Schur: {out}")
    # One rank holds every variable: no boundary.
    _check(out["n_boundary"] > 0 or n == 1, "sharded Schur: no boundary")
    summary["schur"] = (out["iterations"], out["n_boundary"])

    # 3 and 3b. Two-level sharded Schur, CG and banded boundaries.
    for boundary in ("cg", "banded"):
        hout = ShardedBlockSchurSolver(constraints, n_vars, n_parts=2 * n, config=Config(),
                                       precision="mixed",
                                       boundary_solver=boundary).solve(x0_big)
        _check(hout["converged"] and hout["satisfied"].all(),
               f"two-level sharded Schur ({boundary}): {hout}")
        summary[f"hier_{boundary}"] = (hout["iterations"], hout["n_boundary"])
    return summary


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run ``dryrun_rank`` over ``n_devices`` spawned ranks: NCCL on
    ``cuda:0 .. cuda:<n-1>`` by default, or gloo ranks all on ``device``
    (``"cpu"``, or one card shared). Raises with the failing rank's
    traceback; returns rank 0's summary."""
    if device is None:
        return dist.run_ranks(dryrun_rank, n_devices, "nccl")
    return dist.run_ranks(dryrun_rank, n_devices, "gloo", [device] * n_devices)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=None,
                    help="ranks (default: every visible card)")
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    args = ap.parse_args(argv)
    n = args.n_devices
    if n is None:
        n = 8 if args.cpu else torch.cuda.device_count()
    print(f"dryrun_multichip OK: {dryrun_multichip(n, 'cpu' if args.cpu else None)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
