"""Ranks over ``torch.distributed``: the port's counterpart of a device mesh.

The JAX package runs its sharded solvers under ``shard_map`` over a 1-D
``Mesh`` and sums packets with ``lax.psum``. Here every device is a rank
of its own process (SPMD): each rank holds its shard on its own device, and
every ``psum`` is one ``torch.distributed.all_reduce`` of one packed tensor.

* Backends: NCCL between cards, one rank per card (NCCL refuses two ranks
  on one GPU, and ``init`` says so before NCCL does); gloo on the CPU, and
  for several ranks that share one card (their tensors pass through the
  host).
* The process group is the caller's choice: ``init`` joins one (or call
  ``torch.distributed.init_process_group`` directly, and the rank's device
  is then ``cuda:<LOCAL_RANK>``). With no group a solver is a world of one
  on its device and every collective is the identity, as under JAX's
  default 1-device mesh. That is not a device fallback: the device is
  resolved as everywhere in the port, the card unless the caller names
  another.
* ``run_ranks`` starts ranks with the spawn start method (a parent that
  has initialised CUDA cannot fork) and returns rank 0's result; a rank
  that raises fails the call with that rank's traceback.
* ``Comm`` is one solver's view of the world. Its ``psum`` is the one
  collective per reduction; a max rides in the same sum through
  ``onehot`` (each rank writes its value in its own slot of the packed
  vector, and the max is taken after the sum), as the JAX solvers fold
  their ``pmax`` into a ``psum``. It counts the collectives it issues and
  their bytes, and the host syncs its solver makes.
"""

from __future__ import annotations

import os
import pickle
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as tdist

from ..solver import resolve_device

# The device this process joined its group on (``init``), if it did.
_RANK_DEVICE: Optional[torch.device] = None


def initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def _check_backend(backend: str, device: torch.device) -> None:
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL runs between GPUs; a rank on {device} needs backend='gloo'")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r} (nccl or gloo)")


def init(rank: int, world_size: int, backend: str, init_method: str,
         device=None) -> torch.device:
    """Join the process group as ``rank`` of ``world_size`` through
    ``init_method`` (``tcp://host:port``), on ``device`` (default
    ``cuda:<LOCAL_RANK>``). Under NCCL the ranks' cards are compared first
    (through a gloo side group) and two ranks on one card raise here, with
    the remedy, instead of as NCCL's "Duplicate GPU detected". Returns the
    rank's device."""
    global _RANK_DEVICE
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    dev = resolve_device(device)
    _check_backend(backend, dev)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"rank {rank} wants {dev}, but this host has "
                             f"{torch.cuda.device_count()} visible GPUs")
        torch.cuda.set_device(dev)
    tdist.init_process_group(backend, init_method=init_method,
                             world_size=world_size, rank=rank)
    _RANK_DEVICE = dev
    if backend == "nccl" and world_size > 1:
        side = tdist.new_group(backend="gloo")
        seen = [None] * world_size
        tdist.all_gather_object(seen, (socket.gethostname(), dev.index), group=side)
        tdist.destroy_process_group(side)
        first = {}
        for r, key in enumerate(seen):
            if key in first:
                tdist.destroy_process_group()
                _RANK_DEVICE = None
                raise RuntimeError(
                    f"ranks {first[key]} and {r} are both on cuda:{key[1]} of host "
                    f"{key[0]}: NCCL needs one rank per GPU; use backend='gloo' for "
                    f"several ranks on one card")
            first[key] = r
    return dev


def shutdown() -> None:
    """Leave the process group that ``init`` joined."""
    global _RANK_DEVICE
    if initialized():
        tdist.destroy_process_group()
    _RANK_DEVICE = None


def rank_device(device=None) -> torch.device:
    """The device of this rank: ``device`` when given; else the one
    ``init`` joined on; else ``cuda:<LOCAL_RANK>`` under a group that the
    caller started; else the card (``solver.resolve_device``)."""
    if device is not None:
        return resolve_device(device)
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    if initialized():
        return resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")
    return resolve_device(None)


class Comm:
    """One solver's view of the world: ``rank`` of ``size`` on ``device``,
    over ``group`` (the default group; ``None`` with no group up is a world
    of one). A rank outside ``group`` raises. Counters (``reset`` zeroes
    them): ``collectives`` and ``bytes`` (the payload of each sum, max or
    gather, barriers at 0 bytes), ``host_syncs``."""

    def __init__(self, device=None, group=None):
        self.distributed = initialized()
        self.group = group
        if self.distributed:
            self.rank = tdist.get_rank(group)
            if self.rank < 0:
                raise ValueError("this rank is not a member of the solver's group")
            self.size = tdist.get_world_size(group)
            self.backend = tdist.get_backend(group)
        else:
            if group is not None:
                raise ValueError("a group was given but no process group is initialized")
            self.rank, self.size, self.backend = 0, 1, None
        self.device = rank_device(device)
        if self.backend is not None:
            _check_backend(self.backend, self.device)
        self.reset()

    def reset(self) -> None:
        self.collectives = 0
        self.bytes = 0
        self.host_syncs = 0

    def _count(self, t: torch.Tensor) -> None:
        self.collectives += 1
        self.bytes += t.numel() * t.element_size()

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        self._count(t)
        if not self.distributed:
            return t
        if self.backend == "gloo" and t.device.type != "cpu":
            host = t.cpu()
            tdist.all_reduce(host, op=op, group=self.group)
            t.copy_(host)
        else:
            tdist.all_reduce(t, op=op, group=self.group)
        return t

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place (returns ``t``)."""
        return self._reduce(t, tdist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max of ``t`` over the ranks, in place."""
        return self._reduce(t, tdist.ReduceOp.MAX)

    def onehot(self, value: torch.Tensor) -> torch.Tensor:
        """``(size,)``: ``value`` in this rank's slot, 0 elsewhere. Packed
        into a ``psum``, the slots' max after the sum is the ranks' max of
        a non-negative value, with no collective of its own."""
        slots = torch.arange(self.size, device=value.device)
        return torch.where(slots == self.rank, value, torch.zeros_like(value))

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """``(size, *t.shape)``: every rank's ``t`` in rank order, on every
        rank (one ``all_gather``)."""
        self._count(t)
        if not self.distributed:
            return t[None]
        src = t.cpu() if self.backend == "gloo" else t.contiguous()
        out = [torch.empty_like(src) for _ in range(self.size)]
        tdist.all_gather(out, src, group=self.group)
        return torch.stack(out).to(t.device)

    def barrier(self) -> None:
        self.collectives += 1
        if self.distributed:
            if self.backend == "nccl":
                tdist.barrier(group=self.group, device_ids=[self.device.index])
            else:
                tdist.barrier(group=self.group)

    def read(self, t: torch.Tensor):
        """``t.item()``: one host sync, counted."""
        self.host_syncs += 1
        return t.item()

    def counts(self, **solver_counts) -> dict:
        """The counters, with the solver's own (``solver_counts``)."""
        return dict(collectives=self.collectives, bytes=self.bytes,
                    host_syncs=self.host_syncs, **solver_counts)


# -- launching ranks ----------------------------------------------------------


def free_port() -> int:
    """A TCP port that is free on localhost now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(local_rank, first_rank, world_size, backend, init_method, devices,
               threads, fn, args, results):
    """A spawned rank: join the group, run ``fn(*args)``, and (the first
    rank of this launch only) send its pickled result home."""
    torch.set_num_threads(threads)
    os.environ["LOCAL_RANK"] = str(local_rank)
    init(first_rank + local_rank, world_size, backend, init_method, devices[local_rank])
    try:
        out = fn(*args)
        if local_rank == 0:
            results.put(pickle.dumps(out))
    finally:
        shutdown()


def spawn_ranks(fn, devices: Sequence, backend: str, init_method: str,
                first_rank: int = 0, world_size: Optional[int] = None, args=()):
    """Start one spawned process per entry of ``devices``, as ranks
    ``first_rank, first_rank + 1, ...`` of ``world_size`` (default: these
    ranks alone), each running ``fn(*args)`` after joining the group
    through ``init_method``; return the result of rank ``first_rank``.
    ``fn`` must be importable by the children (a module-level function of
    the package). A rank that raises fails the call with its traceback."""
    import torch.multiprocessing as tmp

    devices = [str(torch.device(d)) for d in devices]
    world_size = len(devices) if world_size is None else world_size
    for d in devices:
        _check_backend(backend, torch.device(d))
    if backend == "nccl" and len(set(devices)) < len(devices):
        raise ValueError(f"NCCL needs one rank per GPU, and {devices} repeats a card; "
                         f"use backend='gloo' for several ranks on one card")
    threads = max(1, (os.cpu_count() or 1) // len(devices))
    results = tmp.get_context("spawn").SimpleQueue()
    ctx = tmp.start_processes(
        _rank_main, args=(first_rank, world_size, backend, init_method, devices,
                          threads, fn, tuple(args), results),
        nprocs=len(devices), join=False, start_method="spawn")
    # Read the result while the ranks run: a large one fills the pipe, and
    # its writer cannot exit until it is read.
    payload = None
    while True:
        if payload is None and not results.empty():
            payload = results.get()
        if ctx.join(timeout=0.1):
            break
    if payload is None:
        payload = results.get()
    return pickle.loads(payload)


def run_ranks(fn, world_size: int, backend: str = "nccl", devices=None, *args):
    """Run ``fn(*args)`` on ``world_size`` spawned ranks of one host and
    return rank 0's result. ``devices`` lists each rank's device (default
    ``cuda:0 .. cuda:<world_size-1>``, one card per rank, under either
    backend); the CPU, or several gloo ranks on one card, only when listed
    (``"gloo", ["cpu"] * n``)."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(world_size)]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    return spawn_ranks(fn, devices, backend, f"tcp://127.0.0.1:{free_port()}", args=args)
