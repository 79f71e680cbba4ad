"""The port's launcher (``python -m ezpz_tpu_torch.launch``) as TWO local
processes of 2 gloo ranks each against a localhost coordinator (the
single-machine stand-in for two hosts), as ``tests/test_multihost.py``
runs ``tools/multihost_launch.py``; the fleet demo in one process; and
the multi-chip dry run (``dryrun.dryrun_multichip``) over gloo ranks on
the CPU.

The launcher prints the JAX launcher's lines: ``mesh: 2 hosts x 2 chips =
4 devices (cpu)``, and for the schur demo at 4 points per rank a 32-variable
chain sharded over the 4 ranks, ``converged=True``.
"""

import os
import subprocess
import sys

from ezpz_tpu_torch import dryrun
from ezpz_tpu_torch.parallel import dist

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


def _launch(args, processes=1):
    """Run the launcher as ``processes`` local processes; return process
    0's output."""
    extra = []
    if processes > 1:
        extra = ["--coordinator", f"127.0.0.1:{dist.free_port()}",
                 "--num-processes", str(processes)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ezpz_tpu_torch.launch", *extra,
         "--process-id", str(pid), "--cpu", "2", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=HERE)
        for pid in range(processes)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs[0]


def test_two_process_topology():
    """--demo none: every rank of both processes answers the world's sum."""
    out = _launch(["--demo", "none"], processes=2)
    assert "mesh: 2 hosts x 2 chips = 4 devices (cpu)" in out, out


def test_two_process_schur_solve():
    """A coupled chain sharded over both processes' ranks converges."""
    out = _launch(["--demo", "schur", "--points-per-chip", "4"], processes=2)
    assert "converged=True" in out, out
    assert "32 vars" in out and "12 boundary" in out, out


def test_fleet_demo():
    """Each rank solves its sketches with the fused path's FleetSolver
    (its plain version on the CPU); the counts are summed."""
    out = _launch(["--demo", "fleet", "--sketches-per-chip", "64"])
    assert "fleet: 128 sketches" in out and "sketches/sec across 2 chips" in out, out


def test_dryrun_multichip_on_cpu_ranks():
    """Steps 1-3b over 4 gloo ranks: every assertion of the JAX dry run,
    the chains coupled across the ranks (a boundary), 1024 fused-path
    lanes per rank."""
    summary = dryrun.dryrun_multichip(4, device="cpu")
    assert summary["ranks"] == 4 and summary["fused_sketches"] == 4096
    assert summary["schur"][1] > 0
    for key in ("hier_cg", "hier_banded"):
        assert summary[key][1] > 0
