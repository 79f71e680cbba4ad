"""Coupled systems, and work over several devices.

The PyTorch counterpart of ``ezpz_tpu/parallel``:

* ``BlockSchurSolver``: the single-device partitioned-Schur solver for one
  coupled topology and fleets of its copies;
* ``FleetSolver``: a batch of same-topology sketches split over devices,
  with no communication but the scatter and the gather;
* ``ShardedSchurSolver`` and ``ShardedBlockSchurSolver``: one coupled
  system sharded over the ranks of a ``torch.distributed`` process group,
  one rank per device, the JAX solvers' ``psum``s as ``all_reduce``s of
  packed tensors (``dist``: NCCL between cards, gloo on the CPU or for
  ranks sharing a card; a world of one with no group up).
"""

from .block_schur import BlockSchurSolver
from .fleet import FleetSolver
from .hier import ShardedBlockSchurSolver
from .schur import ShardedSchurSolver

__all__ = ["BlockSchurSolver", "FleetSolver", "ShardedBlockSchurSolver",
           "ShardedSchurSolver"]
