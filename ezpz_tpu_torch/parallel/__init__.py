"""Coupled systems, and fleets over several devices.

The PyTorch counterpart of ``ezpz_tpu/parallel``. Ported so far:
``BlockSchurSolver``, the single-device partitioned-Schur solver for one
coupled topology and fleets of its copies, and ``FleetSolver``, which
splits a batch of same-topology sketches over devices with no
communication but the scatter and the gather. ``ShardedSchurSolver`` and
``ShardedBlockSchurSolver``, which sum packets across devices, wait for
the collective slice (ROADMAP.md queue 1 item 9).
"""

from .block_schur import BlockSchurSolver
from .fleet import FleetSolver

__all__ = ["BlockSchurSolver", "FleetSolver"]
