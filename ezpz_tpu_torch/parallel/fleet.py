"""Fleet data-parallelism: split a batch of independent sketches over devices.

The PyTorch counterpart of ``ezpz_tpu/parallel/fleet.py``. The batch axis
of ``BatchSolver`` is embarrassingly parallel (each sketch's LM loop is its
own), so the only communication is the scatter of the inputs and the
gather of the results. ``FleetSolver`` builds one local ``BatchSolver``
per device and hands each its shard:

* f64 and mixed (the batched LM loop): ``B`` must divide by the number of
  devices, as the JAX package's sharded ``jit`` requires; every shard runs
  the single-device path, so per-shard results are the local solver's on
  the same shard by construction;
* the fused kernel (``precision="mixed", pallas_fused=True``): each
  device launches ``csrc/fused_fleet.cu`` on its shard. The CUDA kernel
  takes any number of lanes, so the shards are as even as ``B`` allows
  and nothing is padded (the JAX package pads to its TPU tile).

Shards on different devices run in threads of their own, so no device
waits on another; shards that share a device run one after another on
it. The results are gathered onto the first device. There is no fallback:
a shard on a card launches its kernel or raises.
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import torch

from ..batch import BatchResult, BatchSolver
from ..config import Config
from ..models.compiled import CompiledSystem
from ..utils import debug


def _visible_devices() -> List[torch.device]:
    """Every visible card, in order; raises when there is none (the port
    never runs on the CPU unasked)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "FleetSolver spreads its batch over the visible GPUs and there is "
            "none; pass devices=['cpu'] (repeats allowed) to run on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


class FleetSolver:
    """Solve B same-topology sketches split across ``devices``.

    ``devices`` is a sequence of ``torch.device`` (or names); ``None``
    means every visible card. A device may repeat: its shards then run one
    after another on it (the CPU tests split a batch into 8 shards on one
    CPU, as the JAX tests split it over 8 faked devices). ``config``,
    ``batch_params``, ``precision``, ``pallas_fused``, ``pallas_trips``
    and ``refine_trips`` are ``BatchSolver``'s.

    Pin p, hold q at distance 4, and solve 8 sketches as 8 shards of one:

    >>> import numpy as np
    >>> from ezpz_tpu_torch.constraints import Constraint
    >>> from ezpz_tpu_torch.datatypes import DatumPoint
    >>> from ezpz_tpu_torch.models.compiled import compile_system
    >>> p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    >>> system = compile_system([Constraint.Fixed(0, 0.0),
    ...                          Constraint.Fixed(1, 0.0),
    ...                          Constraint.Distance(p, q, 4.0)], n_vars=4)
    >>> x0 = np.tile([0.0, 0.0, 4.4, 4.4], (8, 1))
    >>> res = FleetSolver(system, devices=["cpu"] * 8).solve(x0)
    >>> bool(res.converged.all())
    True
    """

    def __init__(self, system: CompiledSystem,
                 devices: Optional[Sequence] = None,
                 config: Config = Config(), batch_params: bool = False,
                 precision: str = "f64", pallas_fused: bool = False,
                 pallas_trips: int = 4, refine_trips: int = 4):
        if devices is None:
            devices = _visible_devices()
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("FleetSolver needs at least one device")
        self.system = system
        self.batch_params = batch_params
        self.pallas_fused = pallas_fused
        # One local solver per device; they share the first one's
        # host-side plan (nothing in a BatchSolver but its device is
        # per-device). The first gathers and finishes stragglers.
        self._local = BatchSolver(
            system, config, batch_params=batch_params, precision=precision,
            pallas_fused=pallas_fused, pallas_trips=pallas_trips,
            refine_trips=refine_trips, device=self.devices[0])
        self._solvers = [self._local]
        for d in self.devices[1:]:
            solver = copy.copy(self._local)
            solver.device = d
            self._solvers.append(solver)

    def _shard_sizes(self, B: int) -> List[int]:
        D = len(self.devices)
        if self.pallas_fused and self._local.kernel_ok:
            return [B // D + (1 if i < B % D else 0) for i in range(D)]
        if B % D:
            raise ValueError(f"a batch of {B} sketches does not split evenly over "
                             f"{D} devices; pad the fleet to a multiple of {D}")
        return [B // D] * D

    def solve(self, x0, pars: Optional[Tuple] = None,
              finish_stragglers: bool = False) -> BatchResult:
        """Solve the batch ``x0`` (B, n) (numpy or a tensor on any device),
        with per-sketch ``pars`` when ``batch_params``; the result lies on
        the first device. ``finish_stragglers`` (fused path only): lanes
        the fixed-trip kernel leaves unconverged are re-solved through the
        first device's solver on the plain mixed path and merged."""
        x0 = torch.as_tensor(x0, dtype=torch.float64)
        if self.batch_params and pars is None:
            raise ValueError("batch_params=True requires pars")
        if pars is not None:
            pars = tuple(torch.as_tensor(p, dtype=torch.float64) for p in pars)
        sizes = self._shard_sizes(int(x0.shape[0]))
        starts = [sum(sizes[:i]) for i in range(len(sizes))]
        # A fleet smaller than the device count leaves some devices idle.
        shards = [(solver, x0[a:a + n], None if pars is None else
                   tuple(p[a:a + n] for p in pars))
                  for i, (solver, a, n) in enumerate(zip(self._solvers, starts, sizes))
                  if n > 0 or i == 0]

        by_device = {}
        for i, (solver, _x, _p) in enumerate(shards):
            by_device.setdefault(solver.device, []).append(i)

        def run(indices):
            with debug.armed_in_thread():
                return [(i, _run_shard(*shards[i])) for i in indices]

        groups = list(by_device.values())
        if len(groups) == 1:
            done = run(groups[0])
        else:
            with ThreadPoolExecutor(max_workers=len(groups)) as pool:
                futures = [pool.submit(run, g) for g in groups]
                done = [item for f in futures for item in f.result()]
        results = [res for _i, res in sorted(done, key=lambda item: item[0])]
        first = self.devices[0]
        out = BatchResult(**{
            name: torch.cat([getattr(r, name).to(first) for r in results])
            for name in ("x", "iterations", "converged", "satisfied", "degenerate")})
        if finish_stragglers and self.pallas_fused:
            x0_first = x0.to(first)
            pars_first = None if pars is None else tuple(p.to(first) for p in pars)
            out = self._local._finish_stragglers(out, x0_first, pars_first)
        return out


def _run_shard(solver: BatchSolver, x0, pars) -> BatchResult:
    """One shard on its solver's device."""
    if solver.device.type == "cuda":
        with torch.cuda.device(solver.device):
            return solver.solve(x0, pars)
    return solver.solve(x0, pars)
