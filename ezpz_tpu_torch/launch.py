"""Multi-host launcher for the sharded solvers and the fleet.

The counterpart of ``tools/multihost_launch.py``. Run this same module once
per host, every copy pointed at the same coordinator (the host:port where
rank 0 listens); each copy starts one rank per local device (spawned
processes), and ``torch.distributed`` joins them into one world:

    # host 0 (also the coordinator):
    python -m ezpz_tpu_torch.launch --coordinator 10.0.0.1:8476 \\
        --num-processes 2 --process-id 0 --demo schur
    # host 1:
    python -m ezpz_tpu_torch.launch --coordinator 10.0.0.1:8476 \\
        --num-processes 2 --process-id 1 --demo schur

By default a copy starts one NCCL rank per visible card. ``--cpu N``
starts N gloo ranks on the CPU instead, which makes the launcher testable
on one machine (two local copies against a localhost coordinator). Without
``--coordinator`` the launch is one process on a free localhost port.

``--demo none`` joins the world and prints its shape (a connectivity
check); ``--demo schur`` solves one coupled chain (``--points-per-chip``
points per rank) sharded over every rank with ``ShardedSchurSolver``;
``--demo fleet`` gives every rank ``--sketches-per-chip`` sketches, which
it solves with ``FleetSolver(precision="mixed", pallas_fused=True)`` on its
own device (the fused kernel on a card), and reports the summed counts
and the slowest rank's time.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .parallel import dist


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _fleet(comm, sketches_per_chip: int):
    from .config import Config
    from .constraints import Constraint
    from .datatypes import DatumLineSegment, DatumPoint
    from .models.compiled import compile_system
    from .parallel import FleetSolver

    p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    system = compile_system([
        Constraint.Vertical(DatumLineSegment(p, q)),
        Constraint.Fixed(p.x_id, 0.0),
        Constraint.Fixed(p.y_id, 0.0),
        Constraint.Distance(p, q, 4.0),
    ], n_vars=4)
    n = sketches_per_chip
    fleet = FleetSolver(system, devices=[comm.device], config=Config(), batch_params=True,
                        precision="mixed", pallas_fused=True)
    x0 = torch.as_tensor(np.tile([0.3, -0.2, 0.8, 3.1], (n, 1)), device=comm.device)
    pars = tuple(torch.as_tensor(np.tile(b.par, (n, 1, 1)), device=comm.device)
                 for b in system.blocks)
    fleet.solve(x0, pars)  # warm-up: the kernel's first load
    _sync(comm.device)
    t0 = time.perf_counter()
    out = fleet.solve(x0, pars)
    _sync(comm.device)
    dt = torch.tensor(time.perf_counter() - t0, dtype=torch.float64, device=comm.device)
    counts = torch.stack([out.converged.sum(), out.satisfied.all(dim=1).sum()]).to(dt)
    packed = comm.psum(torch.cat([counts.to(comm.device), comm.onehot(dt)]))
    B = n * comm.size
    slowest = float(packed[2:].max())
    conv, sat = int(packed[0]), int(packed[1])
    if conv != B or sat != B:
        raise RuntimeError(f"fleet demo: {conv} of {B} converged, {sat} satisfied")
    return (f"fleet: {B:,} sketches in {slowest * 1e3:.1f} ms "
            f"({B / slowest:,.0f} sketches/sec across {comm.size} chips)")


def _schur(comm, points_per_chip: int):
    from .config import Config
    from .fixtures import horizontal_chain
    from .parallel import ShardedSchurSolver

    constraints, x0 = horizontal_chain(points_per_chip * comm.size)
    solver = ShardedSchurSolver(constraints, len(x0), config=Config())
    solver.solve(x0)  # warm-up
    _sync(comm.device)
    t0 = time.perf_counter()
    out = solver.solve(x0)
    _sync(comm.device)
    dt = time.perf_counter() - t0
    return (f"schur: {len(x0):,} vars, {out['n_boundary']} boundary, "
            f"{out['iterations']} LM iterations, converged={out['converged']}, "
            f"{dt * 1e3:.1f} ms/solve across {comm.size} chips")


def launch_rank(demo: str, sketches_per_chip: int, points_per_chip: int,
                n_hosts: int, n_local: int):
    """One rank of the launch: check that the whole world answers (one
    sum of ones), then run the demo. Returns the lines to print."""
    comm = dist.Comm()
    alive = int(comm.psum(torch.ones(1, device=comm.device)).item())
    if alive != comm.size:
        raise RuntimeError(f"{alive} of {comm.size} ranks answered")
    kind = (torch.cuda.get_device_name(comm.device) if comm.device.type == "cuda"
            else "cpu")
    lines = [f"mesh: {n_hosts} hosts x {n_local} chips = {comm.size} devices ({kind})"]
    if demo == "fleet":
        lines.append(_fleet(comm, sketches_per_chip))
    elif demo == "schur":
        lines.append(_schur(comm, points_per_chip))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (omit for one process on localhost)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--demo", choices=["none", "fleet", "schur"], default="none")
    ap.add_argument("--sketches-per-chip", type=int, default=65536)
    ap.add_argument("--points-per-chip", type=int, default=256)
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="N gloo ranks on the CPU in this process (default: one "
                         "NCCL rank per visible card)")
    args = ap.parse_args(argv)

    if args.cpu:
        backend, devices = "gloo", ["cpu"] * args.cpu
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            print("launch: no visible GPU; pass --cpu N for gloo ranks on the CPU",
                  file=sys.stderr)
            return 2
        backend, devices = "nccl", [f"cuda:{i}" for i in range(n)]
    if args.coordinator is None:
        if args.num_processes != 1:
            ap.error("--num-processes > 1 needs --coordinator")
        coordinator = f"127.0.0.1:{dist.free_port()}"
    else:
        coordinator = args.coordinator
    n_local = len(devices)
    lines = dist.spawn_ranks(
        launch_rank, devices, backend, f"tcp://{coordinator}",
        first_rank=args.process_id * n_local, world_size=args.num_processes * n_local,
        args=(args.demo, args.sketches_per_chip, args.points_per_chip,
              args.num_processes, n_local))
    if args.process_id == 0:
        for line in lines:
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
