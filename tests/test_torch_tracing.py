"""The port's spans and counters (``ezpz_tpu_torch/tracing.py``) on the CPU.

* Off: with no profiler running, ``tracing.span`` never enters
  ``record_function`` (the batched LM loop costs a flag check a span).
* Spans: under ``torch.profiler`` a band-tier ``BatchSolver`` solve records
  the seven ``ezpz.*`` spans, each inside the span its layer belongs to,
  one ``ezpz.lm.trip`` a trip.
* Counters: ``h2d.copies`` a solve depends on the topology and the LM
  trips, not on the lanes; a warm ``rect_chain(64)`` solve at the
  benchmark's guesses (three LM steps a lane) makes ``H2D_CHAIN64``, the
  count the benchmark's ``chain64.fleet`` reads a batch on the card.
* ``ops._build.count_launches`` still adds to the wrappers' ``LAUNCHES``,
  under the counters' one lock.
"""

import threading

import numpy as np
import torch

from ezpz_tpu_torch import fixtures, tracing
from ezpz_tpu_torch.batch import BatchSolver
from ezpz_tpu_torch.config import Config
from ezpz_tpu_torch.models.compiled import compile_system
from ezpz_tpu_torch.ops import _build, banded_spd, fused_fleet
from ezpz_tpu_torch.ops.linalg import spd_solve

# Host-to-device copies of one warm rect_chain(64) BatchSolver solve
# (mixed, the band tier; every lane at 3 LM steps).
H2D_CHAIN64 = 94
SPANS = ("ezpz.batch.solve", "ezpz.lm.trip", "ezpz.lm.read", "ezpz.lm.jacobian",
         "ezpz.lm.assemble", "ezpz.lm.damped_solve", "ezpz.lm.eval")
# The span each span opens in (``None``: outside every ``ezpz.*`` span).
PARENTS = {
    "ezpz.batch.solve": {None},
    "ezpz.lm.trip": {"ezpz.batch.solve"},
    # The read that starts a loop precedes its first trip.
    "ezpz.lm.read": {"ezpz.lm.trip", "ezpz.batch.solve"},
    "ezpz.lm.jacobian": {"ezpz.lm.trip"},
    "ezpz.lm.assemble": {"ezpz.lm.trip"},
    "ezpz.lm.damped_solve": {"ezpz.lm.trip"},
    "ezpz.lm.eval": {"ezpz.lm.trip"},
}


def _chain(R, lanes, seed=0):
    """A mixed band-tier ``BatchSolver`` on ``rect_chain(R)`` and its
    inputs: the fixture's guesses moved by N(0, 0.05) on each lane."""
    cons, x0 = fixtures.rect_chain(R)
    system = compile_system(cons, len(x0))
    solver = BatchSolver(system, Config(), batch_params=True, precision="mixed",
                         device="cpu")
    assert solver.spd is not spd_solve  # the band tier
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(x0 + rng.normal(0.0, 0.05, (lanes, len(x0))))
    pars = tuple(torch.as_tensor(b.par).expand(lanes, -1, -1).contiguous()
                 for b in system.blocks)
    return solver, x, pars


def _copies(fn):
    before = tracing.counts().get("h2d.copies", 0)
    out = fn()
    return tracing.counts().get("h2d.copies", 0) - before, out


def test_span_off_never_enters_record_function(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tracing.span("ezpz.lm.trip") is tracing.span("ezpz.batch.solve")
    solver, x, pars = _chain(4, 3)
    assert bool(solver.solve(x, pars).converged.all())


def test_spans_nest_by_layer_one_trip_a_trip():
    solver, x, pars = _chain(4, 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = solver.solve(x, pars)
    assert bool(res.converged.all())
    spans = sorted(((e.time_range.start, -e.time_range.end, e.name)
                    for e in prof.events() if e.name.startswith("ezpz.")))
    found = {name: 0 for name in SPANS}
    stack = []  # the open spans, innermost last: (end, name)
    for start, neg_end, name in spans:
        while stack and stack[-1][0] <= start:
            stack.pop()
        assert (stack[-1][1] if stack else None) in PARENTS[name], (name, stack)
        found[name] += 1
        stack.append((-neg_end, name))
    trips = found["ezpz.lm.trip"]
    assert found["ezpz.batch.solve"] == 1
    assert trips >= int(res.iterations.max()) > 0
    for name in ("ezpz.lm.jacobian", "ezpz.lm.assemble", "ezpz.lm.damped_solve",
                 "ezpz.lm.eval"):
        assert found[name] == trips, (name, found)
    # One read ends each trip; the f32 phase and the refinement each start
    # with one more.
    assert found["ezpz.lm.read"] == trips + 2


def test_h2d_copies_do_not_grow_with_lanes():
    counted = []
    for lanes in (4, 64):
        solver, x, pars = _chain(4, lanes)
        solver.solve(x, pars)  # the band's index tables, once
        n, res = _copies(lambda: solver.solve(x, pars))
        assert bool(res.converged.all()) and int(res.iterations.max()) == 3
        counted.append(n)
    assert counted[0] == counted[1] > 0


def test_h2d_copies_of_a_chain64_batch():
    solver, x, pars = _chain(64, 4)
    first, _ = _copies(lambda: solver.solve(x, pars))
    n, res = _copies(lambda: solver.solve(x, pars))
    assert (res.iterations == 3).all() and bool(res.converged.all())
    assert n == H2D_CHAIN64
    assert first == n + 3  # the band's row, column and mask tables


def test_count_launches_adds_under_the_counters_lock():
    before = fused_fleet.LAUNCHES, banded_spd.LAUNCHES["lanes"]
    _build.count_launches(fused_fleet.__name__, 2)
    _build.count_launches(banded_spd.__name__, 3, "lanes")
    assert (fused_fleet.LAUNCHES, banded_spd.LAUNCHES["lanes"]) == (
        before[0] + 2, before[1] + 3)
    done = threading.Event()
    with tracing.LOCK:
        t = threading.Thread(target=lambda: (_build.count_launches(
            fused_fleet.__name__, 1), done.set()))
        t.start()
        assert not done.wait(0.2)
    t.join(5)
    assert done.is_set() and fused_fleet.LAUNCHES == before[0] + 3


def test_counts_is_a_snapshot():
    snap = tracing.counts()
    kept = dict(snap)
    tracing.count("test.snapshot", 4)
    tracing.count("test.snapshot")
    assert tracing.counts()["test.snapshot"] == snap.get("test.snapshot", 0) + 5
    assert snap == kept  # a copy: later counts leave it as it was
