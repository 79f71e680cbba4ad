"""The port's public API against the JAX package's, on the CPU.

* Every corpus fixture goes through both packages'
  ``Problem.from_str(...).to_constraint_system().solve_with_config_analysis``
  (the port with ``device="cpu"``; each package solves each fixture once
  per module): converged flag, iteration count (equal to each other and to
  ``tests/golden_iterations.json``), unsatisfied and underconstrained
  lists, warnings (kind and constraint id), ``priority_solved``,
  ``num_vars``/``num_eqs`` exactly; coordinates within 1e-6 on fully
  constrained fixtures and 1e-4 (the corpus tolerance of
  ``tests/test_golden_fixtures.py``) on underconstrained ones, where two
  least-squares answers may both be right.
* The cases of ``tests/test_api.py`` (priority cascade, empty system,
  errors, weights, tangency sides, degenerate warnings, ``time_resolves``)
  run through both packages and must give the same outcome.
* The cases of ``tests/test_block_api.py`` (decomposition threshold,
  block path equal to the monolithic one, scatter of flags, unreferenced
  guesses, global-tolerance analysis, the solver cache's limit) hold on
  the port.
* The port's own rules: the default device is the card, so here, where
  there is none, ``solve`` raises; the package exports the JAX package's
  public names.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import ezpz_tpu as J
import ezpz_tpu_torch as T
from ezpz_tpu.textual import Problem as JProblem
from ezpz_tpu_torch import api as tapi
from ezpz_tpu_torch.models.blocks import BlockProgram
from ezpz_tpu_torch.models.compiled import CompiledSystem
from ezpz_tpu_torch.textual import Problem as TProblem

from .test_torch_frontend import FIXTURES, fixture_text

CPU = {"device": "cpu"}
PINS = json.load(open(os.path.join(os.path.dirname(__file__), "golden_iterations.json")))
_RUNS = {}


def _fixture_runs(name):
    """(JAX, port) ``solve_with_config_analysis`` of one fixture, once per
    module."""
    if name not in _RUNS:
        txt = fixture_text(name)
        j = JProblem.from_str(txt).to_constraint_system().solve_with_config_analysis()
        t = TProblem.from_str(txt).to_constraint_system().solve_with_config_analysis(**CPU)
        _RUNS[name] = (j, t)
    return _RUNS[name]


def _warnings(ws):
    return [(w.about_constraint, w.content.value, w.angle_degrees) for w in ws]


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_matches_jax(name):
    j, t = _fixture_runs(name)
    jo, to = j.outcome, t.outcome
    assert to.converged == jo.converged
    assert to.iterations == jo.iterations == PINS[name]
    assert to.unsatisfied == jo.unsatisfied
    assert t.analysis.underconstrained() == j.analysis.underconstrained()
    assert _warnings(to.warnings) == _warnings(jo.warnings)
    assert (to.priority_solved, to.num_vars, to.num_eqs) == (
        jo.priority_solved, jo.num_vars, jo.num_eqs)
    assert list(to.points) == list(jo.points)
    assert list(to.circles) == list(jo.circles)
    assert list(to.arcs) == list(jo.arcs)
    assert to.lines == jo.lines
    atol = 1e-4 if t.analysis.is_underconstrained() else 1e-6
    np.testing.assert_allclose(to.final_values, jo.final_values, rtol=0, atol=atol)
    for label, p in to.points.items():
        q = jo.points[label]
        assert math.hypot(p.x - q.x, p.y - q.y) <= atol * 2


def test_massive_takes_the_block_path_in_both_packages():
    """``massive_parallel_system`` (600 components per copy) is solved by
    ``BlockProgram`` in both packages, on the pinned 2 iterations."""
    from ezpz_tpu import api as japi
    from ezpz_tpu.models.blocks import BlockProgram as JBlockProgram

    _fixture_runs("massive_parallel_system")
    cs = TProblem.from_str(fixture_text("massive_parallel_system")).to_constraint_system()
    jcs = JProblem.from_str(fixture_text("massive_parallel_system")).to_constraint_system()
    n = len(cs.initial_guesses)
    tsys, _ = tapi._get_system_and_solver([r.constraint for r in cs.constraints],
                                          [1.0] * len(cs.constraints), n, 35, **CPU)
    jsys, _ = japi._get_system_and_solver([r.constraint for r in jcs.constraints],
                                          [1.0] * len(jcs.constraints), n, 35)
    assert isinstance(tsys, BlockProgram) and isinstance(jsys, JBlockProgram)
    assert tsys.n_components == jsys.n_components == 1800


def hp(ez, c):
    return ez.ConstraintRequest.highest_priority(c)


def _both(build, analysis=False, config=None, expect_failure=False):
    """Run ``build(ez) -> (reqs, guesses)`` through both packages'
    ``solve`` (or ``solve_analysis``); returns (JAX result, port result),
    or the two ``FailureOutcome``s."""
    out = []
    for ez, kw in ((J, {}), (T, CPU)):
        reqs, guesses = build(ez)
        cfg = config(ez) if config else ez.Config()
        fn = ez.solve_analysis if analysis else ez.solve
        if expect_failure:
            with pytest.raises(ez.FailureOutcome) as exc:
                fn(reqs, guesses, cfg, **kw)
            out.append(exc.value)
        else:
            out.append(fn(reqs, guesses, cfg, **kw))
    return out


def _assert_same(j, t, atol=1e-9):
    if hasattr(j, "analysis"):
        assert t.analysis.underconstrained() == j.analysis.underconstrained()
        j, t = j.outcome, t.outcome
    assert t.unsatisfied == j.unsatisfied
    assert t.converged == j.converged
    assert t.iterations == j.iterations
    assert t.priority_solved == j.priority_solved
    assert _warnings(t.warnings) == _warnings(j.warnings)
    np.testing.assert_allclose(t.final_values, j.final_values, rtol=0, atol=atol)


def test_empty_guesses_fail_alike():
    j, t = _both(lambda ez: ([hp(ez, ez.Constraint.Fixed(0, 0.0))], []),
                 expect_failure=True)
    assert type(t.error).__name__ == type(j.error).__name__ == "MissingGuess"
    assert (t.error.constraint_id, t.error.variable) == (0, 0)
    assert (t.num_vars, t.num_eqs) == (j.num_vars, j.num_eqs)


@pytest.mark.parametrize("case", ["best_satisfied", "original_indices"])
def test_priority_cascade_matches_jax(case):
    prios = {"best_satisfied": (0, 1, 1), "original_indices": (1, 0, 0)}[case]

    def build(ez):
        reqs = [ez.ConstraintRequest.new(ez.Constraint.Fixed(0, v), p)
                for v, p in zip((0.0, 1.0, 2.0), prios)]
        return reqs, [(0, 0.5)]

    j, t = _both(build, analysis=True)
    _assert_same(j, t)
    assert t.outcome.priority_solved == 0
    if case == "best_satisfied":
        assert t.outcome.is_satisfied()
    else:
        assert t.outcome.unsatisfied == [1, 2]


def test_initials_become_finals_without_constraints():
    j, t = _both(lambda ez: ([], [(0, 0.5)]), analysis=True)
    _assert_same(j, t)
    assert t.outcome.final_values == [0.5] and t.analysis.underconstrained() == []


def test_weight_biases_inconsistent_solution():
    def weighted(ez):
        return [hp(ez, ez.Constraint.Fixed(0, 0.0)),
                hp(ez, ez.Constraint.Fixed(0, 100.0)).with_weight(100.0)], [(0, 50.0)]

    def plain(ez):
        return [hp(ez, ez.Constraint.Fixed(0, 0.0)),
                hp(ez, ez.Constraint.Fixed(0, 100.0))], [(0, 50.0)]

    j, t = _both(weighted)
    _assert_same(j, t)
    assert t.final_values[0] > 99.0
    j, t = _both(plain)
    _assert_same(j, t)
    assert abs(t.final_values[0] - 50.0) < 1e-4


@pytest.mark.parametrize(
    "side,center_y_guess,expected_center_y",
    [("Left", 1.5, 4.5), ("Right", 4.5, 1.5), ("Undefined", 4.5, 4.5),
     ("Undefined", 1.5, 1.5)],
)
def test_line_tangent_sides(side, center_y_guess, expected_center_y):
    def build(ez):
        ids = ez.IdGenerator()
        p0, p1, center = ez.DatumPoint.new(ids), ez.DatumPoint.new(ids), ez.DatumPoint.new(ids)
        radius = ez.DatumDistance(ids.next_id())
        circle = ez.DatumCircle(center=center, radius=radius)
        reqs = [hp(ez, c) for c in [
            ez.Constraint.Fixed(p0.id_y(), 3.0),
            ez.Constraint.Fixed(p1.id_y(), 3.0),
            ez.Constraint.CircleRadius(circle, 1.5),
            ez.Constraint.LineTangentToCircle(ez.DatumLineSegment(p0, p1), circle,
                                              getattr(ez.LineSide, side))]]
        guesses = [(p0.id_x(), 0.0), (p0.id_y(), 3.0), (p1.id_x(), 5.0),
                   (p1.id_y(), 3.0), (center.id_x(), 2.0),
                   (center.id_y(), center_y_guess), (radius.id, 1.5)]
        return reqs, guesses

    j, t = _both(build)
    _assert_same(j, t)
    assert t.is_satisfied()
    assert abs(t.final_values[5] - expected_center_y) < 1e-4


@pytest.mark.parametrize("ra,rb,bx_guess,expected", [(2.0, 3.0, 4.0, 5.0),
                                                     (5.0, 2.0, 1.0, 3.0)])
def test_circle_tangent_inferred(ra, rb, bx_guess, expected):
    def build(ez):
        ids = ez.IdGenerator()
        a = ez.DatumCircle(center=ez.DatumPoint.new(ids), radius=ez.DatumDistance(ids.next_id()))
        b = ez.DatumCircle(center=ez.DatumPoint.new(ids), radius=ez.DatumDistance(ids.next_id()))
        guesses = [(a.center.id_x(), 0.0), (a.center.id_y(), 0.0), (a.radius.id, ra),
                   (b.center.id_x(), bx_guess), (b.center.id_y(), 0.0), (b.radius.id, rb)]
        reqs = [hp(ez, c) for c in [
            ez.Constraint.Fixed(a.radius.id, ra), ez.Constraint.Fixed(b.radius.id, rb),
            ez.Constraint.CircleTangentToCircle(a, b, ez.CircleSide.Undefined)]]
        return reqs, guesses

    j, t = _both(build)
    _assert_same(j, t)
    fv = t.final_values
    assert abs(math.hypot(fv[3] - fv[0], fv[4] - fv[1]) - expected) < 1e-4


def test_degenerate_geometry_warns_alike():
    """ArcLength with the start on the center: one DEGENERATE warning, on
    the same constraint, in both packages."""
    def build(ez):
        ids = ez.IdGenerator()
        arc = ez.DatumCircularArc(center=ez.DatumPoint.new(ids),
                                  start=ez.DatumPoint.new(ids), end=ez.DatumPoint.new(ids))
        guesses = [(0, 0.0), (1, 0.0), (2, 0.0), (3, 0.0), (4, 1.0), (5, 0.0)]
        reqs = [hp(ez, c) for c in [
            ez.Constraint.Fixed(arc.center.id_x(), 0.0),
            ez.Constraint.Fixed(arc.center.id_y(), 0.0),
            ez.Constraint.Fixed(arc.start.id_x(), 0.0),
            ez.Constraint.Fixed(arc.start.id_y(), 0.0),
            ez.Constraint.ArcLength(arc, 1.0)]]
        return reqs, guesses

    j, t = _both(build)
    _assert_same(j, t)
    assert [(w.about_constraint, w.content.value) for w in t.warnings] == [(4, "degenerate")]


def test_lint_warning_through_the_textual_solve():
    txt = """# constraints
point p
point q
p.x = 0
p.y = 0
q.y = 0
vertical(p, q)
point r
point s
r.x = 0
s.x = 0
s.y = 0
lines_at_angle(p, q, r, s, 0rad)

# guesses
p roughly (3, 4)
q roughly (5, 6)
r roughly (3, 4)
s roughly (5, 6)
"""
    t = TProblem.from_str(txt).to_constraint_system().solve(**CPU)
    j = JProblem.from_str(txt).to_constraint_system().solve()
    assert _warnings(t.warnings) == _warnings(j.warnings)
    assert (7, "should_be_parallel", 0.0) in _warnings(t.warnings)
    assert (t.iterations, t.unsatisfied) == (j.iterations, j.unsatisfied)


def test_time_resolves_timing_invariants():
    """A per-solve mean in seconds, positive and within the call's wall
    time, for both protocols, on a two-tier cascade; 100 repeats by
    default."""
    import inspect
    import time

    ids = T.IdGenerator()
    p = T.DatumPoint.new(ids)
    reqs = [T.ConstraintRequest(constraint=T.Constraint.Fixed(p.id_x(), 1.0),
                                priority=0, weight=1.0),
            T.ConstraintRequest(constraint=T.Constraint.Fixed(p.id_y(), 2.0),
                                priority=1, weight=1.0)]
    guesses = [(p.id_x(), 0.5), (p.id_y(), 1.5)]
    T.solve(reqs, guesses, **CPU)
    for pipelined in (False, True):
        t0 = time.perf_counter()
        mean = tapi.time_resolves(reqs, guesses, iters=3, pipelined=pipelined, **CPU)
        assert 0.0 < mean <= time.perf_counter() - t0
    assert inspect.signature(tapi.time_resolves).parameters["iters"].default == 100


def test_default_device_is_the_card():
    """No ``device``: the API solves on the GPU, so on a machine without
    one every entry point raises instead of answering on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: tests/test_torch_cuda.py covers it")
    reqs = [T.ConstraintRequest.highest_priority(T.Constraint.Fixed(0, 1.0))]
    cs = TProblem.from_str(fixture_text("tiny")).to_constraint_system()
    calls = [lambda: T.solve(reqs, [(0, 0.0)]),
             lambda: T.solve_analysis(reqs, [(0, 0.0)]),
             lambda: tapi.time_resolves(reqs, [(0, 0.0)], iters=1),
             cs.solve, cs.solve_with_config_analysis, cs.solve_no_metadata,
             lambda: BlockProgram([T.Constraint.Fixed(0, 1.0)], 1)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_all_is_the_jax_packages():
    assert set(T.__all__) == set(J.__all__) - {"enable_compilation_cache"}
    for name in T.__all__:
        assert hasattr(T, name), name


# -- the decomposed path (tests/test_block_api.py) ---------------------------

def _fleet(ez, K=12, inconsistent_at=None, degenerate_at=None):
    """K independent blocks (fixed point + distance); optionally one
    unsatisfiable (a second, contradictory distance) or degenerate (a
    zero-length mirror line) block."""
    ids = ez.IdGenerator()
    reqs, guesses = [], []
    for k in range(K):
        p, q = ez.DatumPoint.new(ids), ez.DatumPoint.new(ids)
        cs = [ez.Constraint.Fixed(p.id_x(), float(k)),
              ez.Constraint.Fixed(p.id_y(), 0.0),
              ez.Constraint.Distance(p, q, 2.0 + (k % 3))]
        if inconsistent_at == k:
            cs.append(ez.Constraint.Distance(p, q, 100.0 + k))
        if degenerate_at == k:
            a, b = ez.DatumPoint.new(ids), ez.DatumPoint.new(ids)
            cs.append(ez.Constraint.Symmetric(ez.DatumLineSegment(p, p), a, b))
            guesses += [(a.id_x(), 1.0), (a.id_y(), 0.5), (b.id_x(), -1.0), (b.id_y(), 0.5)]
        reqs += [ez.ConstraintRequest.highest_priority(c) for c in cs]
        guesses += [(p.id_x(), float(k) + 0.1), (p.id_y(), -0.05),
                    (q.id_x(), float(k) + 1.3), (q.id_y(), 1.1)]
    guesses.sort(key=lambda g: g[0])
    return reqs, guesses


def test_path_selection_threshold(monkeypatch):
    reqs, guesses = _fleet(T)
    constraints = [r.constraint for r in reqs]
    weights = [1.0] * len(constraints)
    for env, kind in (("8", BlockProgram), ("13", CompiledSystem), ("0", CompiledSystem)):
        monkeypatch.setenv("EZPZ_TPU_DECOMPOSE_MIN", env)
        system, _ = tapi._get_system_and_solver(constraints, weights, len(guesses), 50, **CPU)
        assert isinstance(system, kind), env
    monkeypatch.setenv("EZPZ_TPU_DECOMPOSE_MIN", "8")
    assert tapi._get_system_and_solver(constraints, weights, len(guesses), 50,
                                       **CPU)[0].n_components == 12


def test_decompose_threshold_default_and_equality(monkeypatch):
    monkeypatch.delenv("EZPZ_TPU_DECOMPOSE_MIN", raising=False)
    assert tapi._DECOMPOSE_MIN_DEFAULT == 32
    constraints = [T.Constraint.Fixed(i, float(i)) for i in range(32)]
    system, _ = tapi._get_system_and_solver(constraints, [1.0] * 32, 32, 50, **CPU)
    assert isinstance(system, BlockProgram) and system.n_components == 32
    system31, _ = tapi._get_system_and_solver(constraints[:31], [1.0] * 31, 31, 50, **CPU)
    assert isinstance(system31, CompiledSystem)


def test_block_path_matches_monolithic_and_jax(monkeypatch):
    """Same convergence, satisfied set, freedom analysis and coordinates
    (1e-6) on both paths of the port and on the JAX block path."""
    monkeypatch.setenv("EZPZ_TPU_DECOMPOSE_MIN", "0")
    mono = T.solve_analysis(*_fleet(T), **CPU)
    monkeypatch.setenv("EZPZ_TPU_DECOMPOSE_MIN", "8")
    blk = T.solve_analysis(*_fleet(T), **CPU)
    jblk = J.solve_analysis(*_fleet(J))
    for other in (mono, jblk):
        assert blk.outcome.converged and other.outcome.converged
        assert blk.outcome.unsatisfied == other.outcome.unsatisfied == []
        np.testing.assert_allclose(blk.outcome.final_values, other.outcome.final_values,
                                   rtol=0, atol=1e-6)
        assert blk.analysis.underconstrained() == other.analysis.underconstrained()
    assert blk.outcome.iterations == jblk.outcome.iterations


def test_block_path_scatters_flags_to_the_right_block(monkeypatch):
    """One unsatisfiable block (requests 15..18) and one degenerate block
    (its Symmetric request is 12): the flags land on those constraints
    alone, as in the JAX package."""
    monkeypatch.setenv("EZPZ_TPU_DECOMPOSE_MIN", "8")
    bad = T.solve(*_fleet(T, inconsistent_at=5), **CPU)
    jbad = J.solve(*_fleet(J, inconsistent_at=5))
    assert bad.unsatisfied == jbad.unsatisfied
    assert bad.unsatisfied and set(bad.unsatisfied) <= {15, 16, 17, 18}
    assert 17 in bad.unsatisfied or 18 in bad.unsatisfied
    deg = T.solve(*_fleet(T, degenerate_at=3), **CPU)
    jdeg = J.solve(*_fleet(J, degenerate_at=3))
    assert _warnings(deg.warnings) == _warnings(jdeg.warnings)
    assert [w.about_constraint for w in deg.warnings if w.content.value == "degenerate"] == [12]


def test_block_path_keeps_unreferenced_guesses(monkeypatch):
    reqs, guesses = _fleet(T, K=10)
    free_id = len(guesses)
    guesses = guesses + [(free_id, 7.25)]
    for env in ("0", "4"):
        monkeypatch.setenv("EZPZ_TPU_DECOMPOSE_MIN", env)
        assert T.solve(reqs, guesses, **CPU).final_values[free_id] == 7.25


def test_block_analysis_keeps_global_tolerances(monkeypatch):
    """A block of weight-1e-12 requests is globally rank-deficient, and a
    guessed-but-unconstrained variable is underconstrained: both paths of
    the port and the JAX block path agree exactly."""
    def build(ez):
        ids = ez.IdGenerator()
        reqs, guesses = [], []
        for k in range(10):
            p, q = ez.DatumPoint.new(ids), ez.DatumPoint.new(ids)
            w = 1e-12 if k == 4 else 1.0
            for c in [ez.Constraint.Fixed(p.id_x(), float(k)), ez.Constraint.Fixed(p.id_y(), 0.0),
                      ez.Constraint.Fixed(q.id_x(), float(k) + 1.0),
                      ez.Constraint.Fixed(q.id_y(), 1.0)]:
                reqs.append(ez.ConstraintRequest(constraint=c, priority=0, weight=w))
            guesses += [(p.id_x(), float(k)), (p.id_y(), 0.0),
                        (q.id_x(), float(k) + 1.0), (q.id_y(), 1.0)]
        guesses.append((len(guesses), 3.5))
        return reqs, guesses

    monkeypatch.setenv("EZPZ_TPU_DECOMPOSE_MIN", "0")
    mono = T.solve_analysis(*build(T), **CPU)
    monkeypatch.setenv("EZPZ_TPU_DECOMPOSE_MIN", "4")
    blk = T.solve_analysis(*build(T), **CPU)
    jblk = J.solve_analysis(*build(J))
    assert (blk.analysis.underconstrained() == mono.analysis.underconstrained()
            == jblk.analysis.underconstrained() == [16, 17, 18, 19, 40])


def test_block_path_mixed_precision(monkeypatch):
    """``precision="mixed"`` through the decomposed path agrees with f64
    on fully constrained blocks."""
    monkeypatch.setenv("EZPZ_TPU_DECOMPOSE_MIN", "8")
    ids = T.IdGenerator()
    reqs, guesses = [], []
    for k in range(12):
        p, q = T.DatumPoint.new(ids), T.DatumPoint.new(ids)
        for c in [T.Constraint.Fixed(p.id_x(), float(k)), T.Constraint.Fixed(p.id_y(), 0.0),
                  T.Constraint.Fixed(q.id_x(), float(k) + 3.0), T.Constraint.Distance(p, q, 5.0)]:
            reqs.append(T.ConstraintRequest.highest_priority(c))
        guesses += [(p.id_x(), k + 0.1), (p.id_y(), -0.05), (q.id_x(), k + 3.2), (q.id_y(), 3.7)]
    f64 = T.solve(reqs, guesses, **CPU)
    mixed = T.solve(reqs, guesses, T.Config().with_precision("mixed"), **CPU)
    assert mixed.converged and mixed.unsatisfied == []
    np.testing.assert_allclose(mixed.final_values, f64.final_values, rtol=0, atol=1e-6)


def test_solver_cache_limit_and_device_key(monkeypatch):
    """The LRU keeps the cache at its limit (256 by default), and a
    solver cached for one device does not serve another."""
    assert tapi._SOLVER_CACHE_LIMIT == 256
    monkeypatch.setattr(tapi, "_SOLVER_CACHE_LIMIT", 3)
    tapi._SOLVER_CACHE.clear()
    try:
        for k in range(4):
            tapi._get_system_and_solver([T.Constraint.Fixed(0, float(k + 1))], [1.0], 1, 50,
                                        **CPU)
        assert len(tapi._SOLVER_CACHE) == 3
        c = [T.Constraint.Fixed(0, 9.0)]
        hit = tapi._get_system_and_solver(c, [1.0], 1, 50, device="cpu")[0]
        assert tapi._get_system_and_solver(c, [1.0], 1, 50,
                                           device=torch.device("cpu"))[0] is hit
        assert tapi._get_system_and_solver(c, [1.0], 1, 50, device="meta")[0] is not hit
        assert [k[-1] for k in tapi._SOLVER_CACHE][-2:] == ["cpu", "meta"]
    finally:
        tapi._SOLVER_CACHE.clear()


@pytest.mark.parametrize("name", FIXTURES)
def test_topology_key_matches_jax(name):
    """The solver cache's key (kernels, variable ids, parameters) is the
    JAX package's, memoized on each constraint."""
    from ezpz_tpu.models.compiled import topology_key as j_topology_key
    from ezpz_tpu_torch.models.compiled import topology_key

    from .test_torch_frontend import jax_system, port_system

    tc, x0 = port_system(name)
    jc, _ = jax_system(name)
    key = topology_key(tc, len(x0))
    assert key == j_topology_key(jc, len(x0))
    assert all("_topo_frag" in c.__dict__ for c in tc)
    assert topology_key(tc, len(x0)) == key
