"""Coupled (not block-diagonal) systems on one device.

The PyTorch counterpart of ``ezpz_tpu/parallel``. Ported so far:
``BlockSchurSolver``, the single-device partitioned-Schur solver for one
coupled topology and fleets of its copies. ``FleetSolver``,
``ShardedSchurSolver`` and ``ShardedBlockSchurSolver``, which spread work
over several devices, wait for the multi-device slice (ROADMAP.md queue 1
item 9).
"""

from .block_schur import BlockSchurSolver

__all__ = ["BlockSchurSolver"]
