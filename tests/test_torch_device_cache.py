"""The per-device table cache (``ezpz_tpu_torch/ops/device_cache.py``) on
the CPU: threads that ask one owner for its tables on one device at once,
all of them building a copy, each get the copy the cache holds (the first
one stored), for every owner that keeps its tables there."""

import sys
import threading

import pytest
import torch

from ezpz_tpu_torch import fixtures, tracing
from ezpz_tpu_torch.models.compiled import compile_system
from ezpz_tpu_torch.ops import banded
from ezpz_tpu_torch.ops.fleet_plan import plan_fleet

THREADS = 12  # more than the cores the tests run on


def _system(R):
    cons, x0 = fixtures.rect_chain(R)
    return compile_system(cons, len(x0))


def _owner(name):
    """``(owner, get)``: ``get(owner, dev)`` returns its tables on ``dev``."""
    if name == "CompiledSystem.tables":
        return _system(4), lambda s, dev: s.tables(dev)
    if name == "BandRoute.tables":
        system = _system(4)
        return banded.BandRoute(system, *banded.plan_band(system)), lambda r, dev: r.tables(dev)
    plan = plan_fleet(_system(3))
    assert plan.kernel is not None
    return plan, lambda p, dev: p.device_tables(dev)


@pytest.mark.parametrize("name", ["CompiledSystem.tables", "BandRoute.tables",
                                  "FleetPlan.device_tables"])
def test_threads_get_the_first_stored_tables(name, monkeypatch):
    owner, get = _owner(name)
    real = tracing.count
    building = threading.Barrier(THREADS, timeout=60)
    first = threading.local()

    def count(counter, n=1):
        # Each thread's first copy waits until every thread is building.
        if not getattr(first, "seen", False):
            first.seen = True
            building.wait()
        real(counter, n)

    monkeypatch.setattr(tracing, "count", count)
    before = tracing.counts().get("h2d.copies", 0)
    got = [None] * THREADS

    def run(k):
        got[k] = get(owner, "cpu")

    threads = [threading.Thread(target=run, args=(k,)) for k in range(THREADS)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    copies = tracing.counts().get("h2d.copies", 0) - before
    held = get(owner, torch.device("cpu"))
    assert held is not None and all(g is held for g in got), name
    # Every thread built its own copy; the later ones were dropped.
    assert copies > 0 and copies % THREADS == 0
    # The call after them read the cache: no copy.
    assert tracing.counts()["h2d.copies"] - before == copies
