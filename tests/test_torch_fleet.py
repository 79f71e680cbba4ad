"""The port's ``parallel.FleetSolver`` against the JAX package's on its
8-device CPU mesh (``tests/test_parallel.py``), against the port's own
``BatchSolver`` shard by shard, and ``fixtures.horizontal_chain`` against
JAX's.

The port's CPU tests split a batch into 8 shards on one CPU (a device may
repeat), as the JAX tests split it over 8 faked devices. What must hold:

* f64: iterations and flags equal to JAX's ``FleetSolver``, x within
  1e-12 (``test_fleet_solver_matches_batch``'s tolerance) where the system
  fixes it;
* mixed: flags equal to JAX's, x within 1e-8 where the system fixes it
  (the f64 refinement finishes both at 1e-8);
* every shard bit-equal to the port's ``BatchSolver`` on the same shard,
  in f64, mixed and the fused route (its plain version on the CPU), and
  the fused route taking any batch size (shards as even as it allows);
* ``ValueError`` for a batch that does not divide by the device count on
  the f64 and mixed paths (the JAX package's contract).
"""

import doctest

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ezpz_tpu import fixtures as JF
from ezpz_tpu.constraints import Constraint as JConstraint
from ezpz_tpu.datatypes import DatumPoint as JPoint
from ezpz_tpu.models import compiled as JC
from ezpz_tpu.parallel import FleetSolver as JFleetSolver
from ezpz_tpu_torch import fixtures as TF
from ezpz_tpu_torch.batch import BatchSolver
from ezpz_tpu_torch.config import Config
from ezpz_tpu_torch.constraints import Constraint as TConstraint
from ezpz_tpu_torch.datatypes import (DatumCircle, DatumDistance, DatumLineSegment,
                                      DatumPoint as TPoint)
from ezpz_tpu_torch.models import compiled as TC
from ezpz_tpu_torch.parallel import FleetSolver, fleet

D = 8
CPUS = ["cpu"] * D


def _distance(C, P):
    """``tests/test_parallel.py``'s system: p pinned, |pq| = 4 (q keeps one
    free direction)."""
    p, q = P(0, 1), P(2, 3)
    return [C.Fixed(0, 0.0), C.Fixed(1, 0.0), C.Distance(p, q, 4.0)]


def _pinned(C, P):
    """The same with q's x pinned too: fully constrained (q = (3, +-4))."""
    p, q = P(0, 1), P(2, 3)
    return [C.Fixed(0, 0.0), C.Fixed(1, 0.0), C.Fixed(2, 3.0), C.Distance(p, q, 5.0)]


SYSTEMS = {"distance": _distance, "pinned": _pinned}


def _guesses(B, seed):
    rng = np.random.default_rng(seed)
    x0 = np.zeros((B, 4))
    x0[:, 2:] = rng.uniform(1.0, 9.0, size=(B, 2))
    return x0


def _pars(system, B):
    return tuple(np.tile(np.asarray(b.par), (B, 1, 1)) for b in system.blocks)


def _need_jax_devices():
    if len(jax.devices()) < D:
        pytest.skip(f"JAX's FleetSolver case needs {D} devices")


def _held(out, ref, name, x_tol):
    """Flags equal; x within ``x_tol`` where the system fixes it: every
    coordinate when fully constrained, else p and |pq| (q's free direction
    moves by the damped step's rounding, ~1e-7 at lambda 1e-9)."""
    for f in ("converged", "satisfied", "degenerate"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)))
    x, xr = out.x.numpy(), np.asarray(ref.x)
    if name == "pinned":
        np.testing.assert_allclose(x, xr, rtol=0, atol=x_tol)
    else:
        np.testing.assert_allclose(x[:, :2], xr[:, :2], rtol=0, atol=x_tol)
        np.testing.assert_allclose(np.hypot(*(x[:, 2:] - x[:, :2]).T),
                                   np.hypot(*(xr[:, 2:] - xr[:, :2]).T), rtol=0, atol=x_tol)
    assert bool(out.converged.all()) and bool(out.satisfied.all())


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_fleet_f64_matches_jax_fleet(name):
    """``test_parallel.py::test_fleet_solver_matches_batch``: 64 sketches
    over 8 devices; iterations equal, x within 1e-12 where fixed."""
    _need_jax_devices()
    x0 = _guesses(64, 3)
    build = SYSTEMS[name]
    ref = JFleetSolver(JC.compile_system(build(JConstraint, JPoint), 4)).solve(
        jnp.asarray(x0))
    out = FleetSolver(TC.compile_system(build(TConstraint, TPoint), 4),
                      devices=CPUS).solve(x0)
    np.testing.assert_array_equal(out.iterations.numpy(), np.asarray(ref.iterations))
    _held(out, ref, name, 1e-12)


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_fleet_mixed_matches_jax_fleet(name):
    """``test_parallel.py::test_fleet_solver_mixed_matches_batch``: flags
    equal, x within 1e-8 where fixed. Iterations are not compared: the
    f32 phase's Gauss-Newton step along a distance is exact up to
    rounding, so whether it lands within tolerance follows XLA's fused
    rounding (measured: 83-92% of lanes equal on ``pinned``, 30% on
    ``distance``, against JAX's ``solve_lm_mixed`` and its
    ``BatchSolver``); ``tests/test_torch_solver.py`` holds the mixed loop's
    iterations on the nonlinear buckets."""
    _need_jax_devices()
    x0 = _guesses(64, 5)
    build = SYSTEMS[name]
    js = JC.compile_system(build(JConstraint, JPoint), 4)
    ts = TC.compile_system(build(TConstraint, TPoint), 4)
    ref = JFleetSolver(js, batch_params=True, precision="mixed").solve(
        jnp.asarray(x0), tuple(jnp.asarray(p) for p in _pars(js, 64)))
    out = FleetSolver(ts, devices=CPUS, batch_params=True, precision="mixed").solve(
        x0, _pars(ts, 64))
    _held(out, ref, name, 1e-8)


def _same(out, ref):
    for name in ("x", "iterations", "converged", "satisfied", "degenerate"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_fleet_shards_equal_batch_solver(precision):
    """Every shard bit-equal to the port's ``BatchSolver`` on that shard."""
    ts = TC.compile_system(_distance(TConstraint, TPoint), 4)
    x0, pars = _guesses(64, 7), _pars(ts, 64)
    out = FleetSolver(ts, devices=CPUS, batch_params=True, precision=precision).solve(
        x0, pars)
    local = BatchSolver(ts, Config(), batch_params=True, precision=precision,
                        device="cpu")
    for s in range(D):
        sl = slice(8 * s, 8 * (s + 1))
        ref = local.solve(x0[sl], tuple(p[sl] for p in pars))
        _same(type(out)(**{k: getattr(out, k)[sl] for k in vars(out)}), ref)


def _nonlinear_system():
    """``tests/test_unrolled_pallas.py``'s well-constrained mixed system:
    distance, vertical, circle radius and a coincidence, weighted."""
    p0, p1 = TPoint(0, 1), TPoint(2, 3)
    circle = DatumCircle(center=TPoint(4, 5), radius=DatumDistance(6))
    cs = [TConstraint.Fixed(p0.x_id, 0.25), TConstraint.Fixed(p0.y_id, 0.1),
          TConstraint.Distance(p0, p1, 3.0),
          TConstraint.Vertical(DatumLineSegment(p0, p1)),
          TConstraint.CircleRadius(circle, 1.5),
          TConstraint.PointsCoincident(p1, circle.center)]
    return TC.compile_system(cs, n_vars=7, weights=[1.0, 1.0, 2.0, 1.0, 1.0, 0.5])


@pytest.mark.parametrize("B,devices", [(37, 4), (64, 8), (3, 4)])
def test_fleet_fused_route_any_batch(B, devices):
    """The fused route (its plain version on CPU tensors) takes any B: the
    shards are as even as B allows (3 lanes over 4 devices leave one
    idle), each bit-equal to ``BatchSolver`` on it, and
    ``finish_stragglers`` merges through the first device's solver as
    ``BatchSolver.solve(finish_stragglers=True)`` does."""
    ts = _nonlinear_system()
    rng = np.random.default_rng(6)
    base = np.array([0.3, 0.1, 0.2, 3.3, 0.25, 3.2, 1.1])
    x0 = np.tile(base, (B, 1)) + rng.normal(0, 0.02, (B, 7))
    pars = _pars(ts, B)
    kw = dict(batch_params=True, precision="mixed", pallas_fused=True)
    fl = FleetSolver(ts, devices=["cpu"] * devices, **kw)
    assert fl._local.kernel_ok
    out = fl.solve(x0, pars)
    assert bool(out.converged.all()) and bool(out.satisfied.all())
    local = BatchSolver(ts, Config(), device="cpu", **kw)
    sizes = fl._shard_sizes(B)
    assert sum(sizes) == B and max(sizes) - min(sizes) <= 1
    start = 0
    for n in sizes:
        sl = slice(start, start + n)
        start += n
        if n:
            _same(type(out)(**{k: getattr(out, k)[sl] for k in vars(out)}),
                  local.solve(x0[sl], tuple(p[sl] for p in pars)))
    # Too few trips leave stragglers; both solvers finish them alike.
    short = dict(kw, pallas_trips=1, refine_trips=1)
    raw = FleetSolver(ts, devices=["cpu"] * devices, **short).solve(x0, pars)
    assert not bool(raw.converged.all())
    fin = FleetSolver(ts, devices=["cpu"] * devices, **short).solve(
        x0, pars, finish_stragglers=True)
    _same(fin, BatchSolver(ts, Config(), device="cpu", **short).solve(
        x0, pars, finish_stragglers=True))
    assert bool(fin.converged.all())


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_fleet_indivisible_batch_raises(precision):
    ts = TC.compile_system(_distance(TConstraint, TPoint), 4)
    fl = FleetSolver(ts, devices=CPUS, batch_params=True, precision=precision)
    with pytest.raises(ValueError, match="does not split evenly"):
        fl.solve(_guesses(60, 1), _pars(ts, 60))


def test_fleet_without_params_raises_when_asked_for_them():
    ts = TC.compile_system(_distance(TConstraint, TPoint), 4)
    with pytest.raises(ValueError, match="requires pars"):
        FleetSolver(ts, devices=CPUS, batch_params=True).solve(_guesses(8, 1))


def test_fleet_docstring_example_runs():
    failures, _tried = doctest.testmod(fleet, verbose=False)
    assert failures == 0


@pytest.mark.parametrize("args", [(5,), (12, 1.1, 0.0, 0.2), (40, 1.0, 0.3, -0.1)])
def test_horizontal_chain_matches_jax(args):
    jc, jx = JF.horizontal_chain(*args)
    tc, tx = TF.horizontal_chain(*args)
    np.testing.assert_array_equal(tx, jx)
    assert len(tc) == len(jc)
    for a, b in zip(tc, jc):
        assert [(i.kernel, i.var_ids, i.params) for i in a.lower()] == \
            [(i.kernel, i.var_ids, i.params) for i in b.lower()]


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_fleet_solver_threads_share_forward_mode(precision):
    """Shards on distinct devices run in threads of their own (four CPU
    device names stand in for four cards). The batched LM loop's Jacobian
    pass is forward-mode AD, whose level is one per process: the threads
    must take turns at it (``ops.kernels.jvp``), and the fleet then equals
    one ``BatchSolver`` on the whole batch."""
    cs, x0 = TF.horizontal_chain(20)
    system = TC.compile_system(cs, len(x0))
    xb = x0 + np.random.default_rng(9).normal(0, 1e-2, (64, len(x0)))
    out = FleetSolver(system, devices=["cpu", "cpu:0", "cpu:1", "cpu:2"],
                      precision=precision).solve(xb)
    ref = BatchSolver(system, Config(), precision=precision, device="cpu").solve(
        torch.as_tensor(xb))
    for name in ("x", "iterations", "converged", "satisfied", "degenerate"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
