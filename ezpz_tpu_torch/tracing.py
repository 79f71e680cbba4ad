"""The port's spans and counters.

``span(name)`` marks a stretch of host work for ``torch.profiler``: while
a profiler runs (the benchmark's traced run, ``cli.py --profile``,
``dryrun``'s profile) it is a ``torch.profiler.record_function``, so the
span lands in the profiler's Chrome trace on the same clock as the
device's kernels; otherwise it is one shared context manager that does
nothing, at the cost of a flag check. Span names are constant strings,
``ezpz.<layer>.<part>``:

* ``ezpz.batch.solve``: ``BatchSolver.solve``, on every route;
* ``ezpz.lm.trip``: one trip of the batched LM loop
  (``solver._lm_while_loop``), from its dispatch to the read of the next
  trip's live lanes;
* ``ezpz.lm.read``: that read, the host blocked until the device drains;
* ``ezpz.lm.jacobian``: the Jacobian passes of
  ``CompiledSystem.normal_equations``;
* ``ezpz.lm.assemble``: the JtJ and Jtr assembly
  (``CompiledSystem._assemble``): JtJ dense, or straight into its lower
  band on the band tier;
* ``ezpz.lm.damped_solve``: ``solver.damped_spd_solve`` (dense) or
  ``solver.damped_band_solve`` (the band tier);
* ``ezpz.lm.eval``: the trial residual of a trip.

``count(name, n)`` adds to a process-wide counter on every device, and
``counts()`` snapshots them all. ``h2d.copies`` counts the host-to-device
copies of host data (``ops.device_cache.to_device``): a topology's tables
once a device (``ops.device_cache.on_device``), and the LM loops' scalars
each solve; ``lm.band_steps`` the band tier's JtJ assemblies, one an LM
trip; ``lm.band_damped`` the band tier's damped solves made in one launch
of the lane kernel (``solver.damped_band_solve`` on the card), one a trip
on that route.
``LOCK`` also guards the kernel wrappers' ``LAUNCHES`` counters
(``ops._build.count_launches``): one lock for every counter of the port.
"""

from __future__ import annotations

import contextlib
import threading

import torch

LOCK = threading.Lock()
_COUNTS: dict = {}
_OFF = contextlib.nullcontext()
_profiler = torch.autograd.profiler


def span(name: str):
    """A ``record_function(name)`` while a profiler records (the module
    flag ``torch.autograd.profiler._is_profiler_enabled``), else a shared
    no-op context manager."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counts() -> dict:
    """A snapshot of every counter, by name."""
    with LOCK:
        return dict(_COUNTS)
