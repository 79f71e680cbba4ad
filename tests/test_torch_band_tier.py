"""The port's band tier (``batch._pick_spd``, ``ops/banded.make_banded_spd``)
against the JAX package's, on the CPU: the counterpart of
``tests/test_banded_tier.py``.

A topology of more than 24 variables whose identity or RCM ordering has a
half-bandwidth of at most 32 (and below n/2 - 1) solves its damped normal
equations in that band, in both packages, on every ``BatchSolver`` route
that runs the batched LM loop: the plain f64 and mixed modes, the coarse
path's refinement, and a kernel mode's topology past the kernel gate. On a
CPU tensor the band takes ``banded_spd_reference``; the card's kernels are
held to it in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Inputs: B = 8 seeded perturbations (sigma 1e-3) of each topology's
guesses, with per-sketch parameters, the same numpy arrays for both
packages. ``rect_chain(8)`` (50 instances) and ``rect_grid(5, 5)`` (122)
have more than 24 instances, so the JAX package's unrolled evaluator does
not enter them.

What must hold, and why:

* ``_pick_spd``: the same tier as JAX's on JAX's own cases, and for the
  band the same plan (the same RCM code); JAX's column-sweep tier (24 < n
  <= 64, no narrow ordering, a TPU device) is the port's dense
  ``spd_solve``;
* f64: converged, iterations, satisfied and degenerate equal on every
  lane, x within 1e-9: both run the same row recurrences in the band, and
  only XLA's reassociation of a row's sums differs;
* mixed: flags equal, iterations equal on >= 99% of lanes and off by at
  most 1 (``tests/test_torch_solver.py``'s standard for f32 phases);
* the coarse path's refinement and the over-gate ``rect_chain(43)`` (260
  instances) run the band (a spy on ``banded_spd_reference``) and pass the
  bench gate: every lane converged and satisfied, the f64 residual
  recomputed <= 1e-8; the over-gate run never reaches the fused kernel's
  plain version.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import ezpz_tpu as JPKG
import ezpz_tpu_torch as TPKG
from ezpz_tpu import batch as JBatch
from ezpz_tpu.config import Config as JConfig
from ezpz_tpu.models import compiled as JC
from ezpz_tpu.ops import banded as JBd
from ezpz_tpu.ops import linalg as JL
from ezpz_tpu_torch import batch as TBatch
from ezpz_tpu_torch import fixtures as TF
from ezpz_tpu_torch.config import Config as TConfig
from ezpz_tpu_torch.models import compiled as TC
from ezpz_tpu_torch.ops import banded as TBd
from ezpz_tpu_torch.ops import fused_fleet
from ezpz_tpu_torch.ops.linalg import spd_solve

from .test_torch_solver import rect_chain

B = 8
SIGMA = 1e-3
FIELDS = ("converged", "satisfied", "degenerate")


def rect_grid(pkg, RX, RY):
    """An RX x RY grid of unit cells pinned at one corner
    (benches/midsize_bench.py): every horizontal edge Horizontal +
    Distance 1, every vertical edge Vertical + Distance 1; built from
    either package."""
    ids = pkg.IdGenerator()
    P = [[pkg.DatumPoint.new(ids) for _ in range(RY + 1)] for _ in range(RX + 1)]
    seg = pkg.DatumLineSegment
    cons = [pkg.Constraint.Fixed(P[0][0].id_x(), 0.0),
            pkg.Constraint.Fixed(P[0][0].id_y(), 0.0)]
    rng = np.random.default_rng(3)
    x0 = np.zeros(2 * (RX + 1) * (RY + 1))
    for i in range(RX + 1):
        for j in range(RY + 1):
            x0[P[i][j].id_x()] = i + rng.normal(0, 0.05)
            x0[P[i][j].id_y()] = j + rng.normal(0, 0.05)
            if i < RX:
                cons.append(pkg.Constraint.Horizontal(seg(P[i][j], P[i + 1][j])))
                cons.append(pkg.Constraint.Distance(P[i][j], P[i + 1][j], 1.0))
            if j < RY:
                cons.append(pkg.Constraint.Vertical(seg(P[i][j], P[i][j + 1])))
                cons.append(pkg.Constraint.Distance(P[i][j], P[i][j + 1], 1.0))
    return cons, x0


def point_chain(pkg, n_points):
    """A pinned chain of unit distances (``tests/test_banded_tier.py``'s
    boundary cases): 2 n_points variables."""
    pts = [pkg.DatumPoint(2 * i, 2 * i + 1) for i in range(n_points)]
    cons = [pkg.Constraint.Fixed(0, 0.0), pkg.Constraint.Fixed(1, 0.0)]
    cons += [pkg.Constraint.Distance(a, b, 1.0) for a, b in zip(pts, pts[1:])]
    return cons, np.zeros(2 * n_points)


def random_pairs(pkg, seed, n_points, n_pairs, span=None):
    """Distance constraints between random pairs of ``n_points`` points (an
    expander: no narrow ordering), or, with ``span``, from each point to
    the point ``span`` further on."""
    pt = lambda i: pkg.DatumPoint(2 * int(i), 2 * int(i) + 1)  # noqa: E731
    if span is not None:
        return [pkg.Constraint.Distance(pt(i), pt(i + span), 1.0)
                for i in range(n_points - span)], np.zeros(2 * n_points)
    rng = np.random.default_rng(seed)
    cons = []
    for _ in range(n_pairs):
        a, b = rng.choice(n_points, size=2, replace=False)
        cons.append(pkg.Constraint.Distance(pt(a), pt(b), 1.0))
    return cons, np.zeros(2 * n_points)


TOPOLOGIES = {
    "point_chain(12)": (point_chain, 12),        # 24 variables: the unrolled tier
    "point_chain(13)": (point_chain, 13),        # 26: the band
    "rect_chain(8)": (rect_chain, 8),
    "rect_chain(24)": (rect_chain, 24),
    "rect_grid(5,5)": (rect_grid, 5, 5),
    "wide(25 points)": (random_pairs, 2, 25, 80),     # JAX: the column sweep
    "expander(100 points)": (random_pairs, 0, 100, 250),
    "span 20 (60 points)": (random_pairs, 4, 60, None, 20),
}


def systems(name):
    fn, *args = TOPOLOGIES[name]
    tcons, x0 = fn(TPKG, *args)
    jcons, _ = fn(JPKG, *args)
    return TC.compile_system(tcons, len(x0)), JC.compile_system(jcons, len(x0)), x0


def jax_tier(jsys):
    spd = JBatch._pick_spd(jsys)
    return "dense" if spd in (JL.spd_solve, JL.spd_solve_batched) else "band"


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_pick_spd_matches_jax(name):
    tsys, jsys, _x0 = systems(name)
    spd = TBatch._pick_spd(tsys)
    assert ("dense" if spd is spd_solve else "band") == jax_tier(jsys)
    want, got = JBd.plan_band(jsys), TBd.plan_band(tsys)
    assert (got is None) == (want is None)
    if want is not None:
        assert got[1] == want[1] <= TBd.BANDED_MAX_BW
        assert (got[0] is None) == (want[0] is None)
        if want[0] is not None:
            np.testing.assert_array_equal(got[0], want[0])
    expected = {"point_chain(12)": "dense", "wide(25 points)": "dense",
                "expander(100 points)": "dense"}.get(name)
    if expected is not None:
        assert jax_tier(jsys) == expected
    elif name != "span 20 (60 points)":
        assert jax_tier(jsys) == "band"


def test_grid_band_is_wider_than_the_chain():
    chain_bw = TBd.plan_band(systems("rect_chain(24)")[0])[1]
    grid_bw = TBd.plan_band(systems("rect_grid(5,5)")[0])[1]
    assert chain_bw <= 8 and chain_bw < grid_bw <= 28


@pytest.mark.parametrize("name,port", [("rect_chain(24)", lambda: TF.rect_chain(24)),
                                       ("rect_grid(5,5)", lambda: TF.rect_grid(5, 5))])
def test_port_fixtures_are_the_bench_topologies(name, port):
    """``fixtures.rect_chain`` and ``rect_grid`` (what ``chip_smoke.py`` and
    the card's tests build) are this file's topologies."""
    tsys, _jsys, x0 = systems(name)
    cons, fx0 = port()
    fsys = TC.compile_system(cons, len(fx0))
    np.testing.assert_array_equal(fx0, x0)
    assert len(fsys.blocks) == len(tsys.blocks)
    for a, b in zip(fsys.blocks, tsys.blocks):
        np.testing.assert_array_equal(a.idx, b.idx)
        np.testing.assert_array_equal(a.par, b.par)


def _inputs(tsys, x0, seed):
    rng = np.random.default_rng(seed)
    xb = x0[None, :] + rng.normal(0.0, SIGMA, (B, len(x0)))
    pars = [np.tile(np.asarray(b.par), (B, 1, 1)) for b in tsys.blocks]
    return xb, pars


@pytest.fixture
def spy(monkeypatch):
    """Counts the calls of the band's plain version (the CPU's band route)
    and of the fused kernel's plain version."""
    calls = {"band": 0, "fused": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(TBd, "banded_spd_reference",
                        counted("band", TBd.banded_spd_reference))
    monkeypatch.setattr(fused_fleet, "fused_fleet_reference",
                        counted("fused", fused_fleet.fused_fleet_reference))
    return calls


@pytest.mark.parametrize("precision", ["f64", "mixed"])
@pytest.mark.parametrize("name", ["rect_chain(8)", "rect_grid(5,5)"])
def test_batch_solver_matches_jax(name, precision, spy):
    tsys, jsys, x0 = systems(name)
    xb, pars = _inputs(tsys, x0, seed=len(x0))
    assert sum(int(b.idx.shape[0]) for b in jsys.blocks) > 24  # no unrolled evaluator
    want = JBatch.BatchSolver(jsys, JConfig(), batch_params=True,
                              precision=precision).solve(
        jnp.asarray(xb), tuple(jnp.asarray(p) for p in pars))
    got = TBatch.BatchSolver(tsys, TConfig(), batch_params=True, precision=precision,
                             device="cpu").solve(xb, pars)
    assert spy["band"] > 0
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert bool(got.converged.all()) and bool(got.satisfied.all())
    its, jits = got.iterations.numpy(), np.asarray(want.iterations)
    if precision == "f64":
        np.testing.assert_array_equal(its, jits)
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-9)
    else:
        assert np.mean(its == jits) >= 0.99 and np.abs(its - jits).max() <= 1


def _bench_gate(tsys, out, pars):
    r, _deg = tsys.residual_and_flags(out.x, tuple(torch.as_tensor(p) for p in pars))
    assert bool(out.converged.all()) and bool(out.satisfied.all())
    assert float(r.abs().max()) <= 1e-8


def test_coarse_path_refines_on_the_band(spy):
    tsys, _jsys, x0 = systems("rect_chain(8)")
    xb, pars = _inputs(tsys, x0, seed=8)
    solver = TBatch.BatchSolver(tsys, TConfig(), batch_params=True, precision="mixed",
                                pallas_coarse=True, pallas_fused=False, device="cpu")
    assert solver.kernel_ok and solver.spd is not spd_solve
    out = solver.solve(xb, pars)
    assert spy["band"] > 0
    _bench_gate(tsys, out, pars)


def test_over_gate_topology_solves_on_the_band(spy):
    cons, x0 = TF.rect_chain(43)
    tsys = TC.compile_system(cons, len(x0))
    xb, pars = _inputs(tsys, x0, seed=43)
    solver = TBatch.BatchSolver(tsys, TConfig(), batch_params=True, precision="mixed",
                                pallas_fused=True, device="cpu")
    assert not solver.kernel_ok and solver.spd is not spd_solve
    out = solver.solve(xb, pars)
    assert spy["band"] > 0 and spy["fused"] == 0
    _bench_gate(tsys, out, pars)


def _old_composition(A, b, n, bw, perm):
    """``make_banded_spd`` before it gathered through the permutation:
    permute the whole matrix, extract its band, solve, scatter back."""
    if perm is not None:
        p = torch.as_tensor(perm)
        A, b = A[:, p][:, :, p], b[:, p]
    x_p, fail = TBd.banded_spd_reference(TBd.dense_to_band(A, bw), b)
    if perm is None:
        return x_p, fail
    x = torch.zeros_like(x_p)
    x[:, p] = x_p
    return x, fail


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("permuted", [False, True])
def test_make_banded_spd_equals_the_permuted_composition(permuted, dtype, monkeypatch):
    """Bit-equal to the permute-then-extract composition on random SPD bands
    (lane 1 not positive definite: fail set, x zero), with the index
    tables copied to the device at the first call only."""
    n, bw = 40, 5
    rng = np.random.default_rng(7 + permuted)
    A = np.zeros((B, n, n))
    for i in range(n):
        for j in range(max(0, i - bw), i):
            A[:, i, j] = A[:, j, i] = rng.uniform(-1.0, 1.0, B)
    A += np.eye(n) * (2.0 * bw + 1.0)
    A[1, n // 2, n // 2] = -1.0
    perm = rng.permutation(n) if permuted else None
    if permuted:  # the band lies in the ordering ``perm``: A's rows are scattered
        inv = np.argsort(perm)
        A = A[:, inv][:, :, inv]
    A, b = torch.as_tensor(A, dtype=dtype), torch.as_tensor(rng.normal(size=(B, n)), dtype=dtype)
    spd = TBd.make_banded_spd(n, bw, perm)
    x, fail = spd(A, b)
    want_x, want_fail = _old_composition(A, b, n, bw, perm)
    assert torch.equal(x, want_x) and torch.equal(fail, want_fail)
    assert fail.tolist() == [k == 1 for k in range(B)]
    assert bool((x[1] == 0).all())
    copies = []
    monkeypatch.setattr(torch, "as_tensor",
                        lambda *a, _f=torch.as_tensor, **k: copies.append(1) or _f(*a, **k))
    again, _ = spd(A, b)
    assert torch.equal(again, x) and not copies
