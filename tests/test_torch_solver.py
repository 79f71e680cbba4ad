"""The port's batched LM loop (``ezpz_tpu_torch.solver``) against the JAX
package's ``solve_lm``, ``solve_lm_mixed`` and ``solve_lm_refine``, vmapped
over the plain ``CompiledSystem``.

Inputs: B = 64 lanes per bucket, cycling over the bucket's components,
each fixture's guesses perturbed by seeded numpy noise (sigma 1e-3), with
the bucket's per-sketch parameters; both packages get the same arrays.

Buckets: eight corpus buckets of at most 24 variables that together cover
every kernel kind of the corpus (15 of the 23), and ``rect_chain(8)``
(50 variables, so the port's library Cholesky against XLA's).

What must hold, and why:

* ``solve_lm`` (f64), n <= 24: converged, iterations and degenerate equal
  on every lane, x within 1e-9 on fully constrained buckets. Both sides run
  the same unrolled Crout on the same normal equations; only summation
  order differs (last-bit rounding). Under-constrained buckets are not
  compared on x: a damped step against a singular JtJ amplifies rounding.
* ``solve_lm`` (f64), n > 24: iterations equal on >= 99% of lanes and off
  by at most 1, x within 1e-8 (another factorization order).
* ``solve_lm_mixed`` and ``solve_lm_refine``: flags equal on lanes without
  NaN rows, iterations equal on >= 99% of lanes, f64 residual <= 1e-8
  wherever JAX converged (f32 phases: rounding can move an accept). The
  four buckets have nonlinear kernels. On buckets of linear kernels
  (``massive_parallel_system``'s, ``tiny``, ``coincident``) an f32 step from
  an f32 point can come out exact, and whether it does depends on
  rounding: XLA's fused f32 arithmetic in the jitted JAX loop rounds the
  step differently from JAX's own op-by-op evaluation (on bucket 1 of the
  massive fixture, lane 2 from its f32-rounded guess: jitted 2 refine
  iterations, op by op 1, the port 1). There the main-path bucket is held
  to flags equal and iterations within 1.
* the pinned counts: ``solve_lm`` on each whole corpus fixture (one lane,
  its guesses) converges in exactly the iterations
  ``tests/golden_iterations.json`` pins for the JAX package's f64 path;
* lane freezing: a lane's x and iterations are the same whether it is
  solved alone or in a batch (the counterpart of
  ``tests/test_unrolled_pallas.py::test_batched_lanes_freeze_on_convergence``).
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import ezpz_tpu as JPKG
import ezpz_tpu_torch as TPKG
from ezpz_tpu import solver as JS
from ezpz_tpu.models import blocks as JB
from ezpz_tpu.models import compiled as JC
from ezpz_tpu_torch import solver as TS
from ezpz_tpu_torch.models import blocks as TB
from ezpz_tpu_torch.models import compiled as TC

from .test_torch_frontend import FIXTURES, jax_system, port_system

B = 64
CFG = dict(max_iterations=35, residual_tolerance=1e-8, step_tolerance=1e-12,
           initial_lambda=1e-9)
# (fixture, bucket, fully constrained)
F64_BUCKETS = [
    ("arc_length", 0, True),
    ("arc_center_point_coincident", 0, False),
    ("arc_center_point_coincident", 1, False),
    ("chamfer_square", 0, True),
    ("circle_tangent", 0, True),
    ("midpoint", 0, True),
    ("square", 0, True),
    ("symmetric", 0, True),
]
MIXED_BUCKETS = [("angle_parallel", 0), ("arc_line_coincident_bug", 0),
                 ("chamfer_square", 0), ("circle_tangent", 0)]


def rect_chain(pkg, R):
    """R rectangles chained corner to corner (benches/midsize_bench.py):
    6R+2 constraints, 2(3R+1) variables; built from either package."""
    ids = pkg.IdGenerator()
    pts = [pkg.DatumPoint.new(ids) for _ in range(3 * R + 1)]
    cons = [pkg.Constraint.Fixed(pts[0].id_x(), 1.0),
            pkg.Constraint.Fixed(pts[0].id_y(), 1.0)]
    guess = [(1.0, 1.0)]
    for k in range(R):
        s, u, v, w = pts[3 * k:3 * k + 4]
        cons += [
            pkg.Constraint.Horizontal(pkg.DatumLineSegment(s, u)),
            pkg.Constraint.Vertical(pkg.DatumLineSegment(u, v)),
            pkg.Constraint.Horizontal(pkg.DatumLineSegment(v, w)),
            pkg.Constraint.Vertical(pkg.DatumLineSegment(w, s)),
            pkg.Constraint.Distance(s, u, 4.0),
            pkg.Constraint.Distance(s, w, 3.0),
        ]
        sx, sy = guess[3 * k]
        guess += [(sx + 3.5, sy + 0.5), (sx + 4.2, sy + 3.4), (sx + 0.5, sy + 2.6)]
    return cons, np.array([c for p in guess for c in p])


def _bucket_case(name, bi, seed):
    """(port system, JAX system, x (B, n), pars list of (B, nk, pk))."""
    tc, x0 = port_system(name)
    jc, _ = jax_system(name)
    tb = TB.build_buckets(tc, len(x0))[bi]
    jb = JB.build_buckets(jc, len(x0))[bi]
    rng = np.random.default_rng(seed)
    k = np.arange(B) % len(tb.components)
    xb = x0[tb.var_index[k]] + rng.normal(0, 1e-3, (B, tb.system.n_vars))
    return tb.system, jb.system, xb, [np.asarray(p)[k] for p in tb.pars]


def _chain_case(seed):
    tcons, x0 = rect_chain(TPKG, 8)
    jcons, _ = rect_chain(JPKG, 8)
    ts = TC.compile_system(tcons, len(x0))
    js = JC.compile_system(jcons, len(x0))
    rng = np.random.default_rng(seed)
    xb = x0[None, :] + rng.normal(0, 1e-3, (B, len(x0)))
    return ts, js, xb, [np.tile(b.par, (B, 1, 1)) for b in ts.blocks]


def _jax_f64(jsys, xb, pars):
    run = jax.jit(jax.vmap(lambda x, p: JS.solve_lm(
        jsys, x, CFG["max_iterations"], CFG["residual_tolerance"],
        CFG["step_tolerance"], CFG["initial_lambda"], pars=p)))
    return run(jnp.asarray(xb), tuple(jnp.asarray(p) for p in pars))


def _np(res):
    return {k: np.asarray(getattr(res, k)) for k in
            ("x", "iterations", "converged", "deg", "residual")}


@pytest.fixture(scope="module")
def f64_runs():
    out = {}
    for seed, (name, bi, full) in enumerate(F64_BUCKETS):
        tsys, jsys, xb, pars = _bucket_case(name, bi, seed)
        j = _np(_jax_f64(jsys, xb, pars))
        t = TS.solve_lm(tsys, torch.as_tensor(xb), CFG["max_iterations"],
                        CFG["residual_tolerance"], CFG["step_tolerance"],
                        CFG["initial_lambda"],
                        pars=tuple(torch.as_tensor(p) for p in pars))
        out[f"{name}[{bi}]"] = (full, j, _np(t))
    return out


@pytest.mark.parametrize("case", [f"{n}[{b}]" for n, b, _f in F64_BUCKETS])
def test_solve_lm_f64_matches_reference(f64_runs, case):
    full, j, t = f64_runs[case]
    np.testing.assert_array_equal(t["converged"], j["converged"])
    np.testing.assert_array_equal(t["iterations"], j["iterations"])
    np.testing.assert_array_equal(t["deg"], j["deg"])
    assert j["converged"].mean() > 0.9
    if full:
        np.testing.assert_allclose(t["x"], j["x"], rtol=0, atol=1e-9)


def test_solve_lm_f64_rect_chain_matches_reference():
    tsys, jsys, xb, pars = _chain_case(seed=50)
    assert tsys.n_vars == 50
    j = _np(_jax_f64(jsys, xb, pars))
    t = _np(TS.solve_lm(tsys, torch.as_tensor(xb), CFG["max_iterations"],
                        CFG["residual_tolerance"], CFG["step_tolerance"],
                        CFG["initial_lambda"],
                        pars=tuple(torch.as_tensor(p) for p in pars)))
    diff = np.abs(t["iterations"].astype(int) - j["iterations"].astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    assert t["converged"].all() and j["converged"].all()
    np.testing.assert_allclose(t["x"], j["x"], rtol=0, atol=1e-8)


def _mixed_pair(tsys, jsys, xb, pars, refine):
    """Both packages' solve_lm_mixed (or solve_lm_refine from a seeded
    coarse state) on the same lanes."""
    j32 = jsys.astype(jnp.float32)
    t32 = tsys.astype(torch.float32)
    args = (CFG["max_iterations"], CFG["residual_tolerance"],
            CFG["step_tolerance"], CFG["initial_lambda"])
    jp = tuple(jnp.asarray(p) for p in pars)
    tp = tuple(torch.as_tensor(p) for p in pars)
    if not refine:
        j = jax.jit(jax.vmap(lambda x, p: JS.solve_lm_mixed(
            jsys, j32, x, *args, pars64=p,
            pars32=tuple(q.astype(jnp.float32) for q in p))))(jnp.asarray(xb), jp)
        t = TS.solve_lm_mixed(tsys, t32, torch.as_tensor(xb), *args, pars64=tp,
                              pars32=tuple(q.float() for q in tp))
        return _np(j), _np(t)
    rng = np.random.default_rng(7)
    x1 = xb.astype(np.float32)
    its = rng.integers(0, 5, B).astype(np.int32)
    deg = rng.random((B, tsys.n_constraints)) < 0.1
    j = jax.jit(jax.vmap(lambda x, i, d, p: JS.solve_lm_refine(
        jsys, j32, x, i, d, *args, pars64=p,
        pars32=tuple(q.astype(jnp.float32) for q in p))))(
        jnp.asarray(x1), jnp.asarray(its), jnp.asarray(deg), jp)
    t = TS.solve_lm_refine(tsys, t32, torch.as_tensor(x1), torch.as_tensor(its),
                           torch.as_tensor(deg), *args, pars64=tp,
                           pars32=tuple(q.float() for q in tp))
    return _np(j), _np(t)


@pytest.mark.parametrize("refine", [False, True], ids=["mixed", "refine"])
@pytest.mark.parametrize("case", MIXED_BUCKETS, ids=[f"{n}[{b}]" for n, b in MIXED_BUCKETS])
def test_mixed_and_refine_match_reference(case, refine):
    name, bi = case
    tsys, jsys, xb, pars = _bucket_case(name, bi, seed=100 + bi)
    j, t = _mixed_pair(tsys, jsys, xb, pars, refine)
    clean = ~(np.isnan(j["residual"]).any(1) | np.isnan(t["residual"]).any(1))
    assert clean.mean() > 0.99
    np.testing.assert_array_equal(t["converged"][clean], j["converged"][clean])
    np.testing.assert_array_equal(t["deg"][clean], j["deg"][clean])
    assert (t["iterations"] == j["iterations"]).mean() >= 0.99
    conv = j["converged"]
    assert conv.mean() > 0.9
    assert np.abs(j["residual"][conv]).max() <= 1e-8
    assert np.abs(t["residual"][conv]).max() <= 1e-8
    assert (t["iterations"] <= CFG["max_iterations"]).all()


@pytest.mark.parametrize("refine", [False, True], ids=["mixed", "refine"])
def test_mixed_and_refine_on_main_path_bucket(refine):
    tsys, jsys, xb, pars = _bucket_case("massive_parallel_system", 1, seed=101)
    j, t = _mixed_pair(tsys, jsys, xb, pars, refine)
    assert j["converged"].all() and t["converged"].all()
    np.testing.assert_array_equal(t["deg"], j["deg"])
    assert np.abs(t["iterations"].astype(int) - j["iterations"]).max() <= 1
    assert np.abs(t["residual"]).max() <= 1e-8


with open(os.path.join(os.path.dirname(__file__), "golden_iterations.json")) as _fh:
    GOLDEN_ITERATIONS = json.load(_fh)


@pytest.mark.parametrize("name", FIXTURES)
def test_golden_iteration_counts(name):
    """The whole fixture as one system (2400 variables for the massive one,
    through the library Cholesky) from its guesses."""
    tc, x0 = port_system(name)
    system = TC.compile_system(tc, len(x0))
    res = TS.solve_lm(system, torch.as_tensor(x0)[None], CFG["max_iterations"],
                      CFG["residual_tolerance"], CFG["step_tolerance"],
                      CFG["initial_lambda"])
    assert bool(res.converged[0])
    assert int(res.iterations[0]) == GOLDEN_ITERATIONS[name]


def test_batched_lanes_freeze_on_convergence():
    """A converged lane's x and iterations are identical whether it is
    solved alone or in a batch with a slower lane."""
    from ezpz_tpu_torch.batch import BatchSolver
    from ezpz_tpu_torch.config import Config

    p0, p1 = TPKG.DatumPoint(0, 1), TPKG.DatumPoint(2, 3)
    system = TC.compile_system([
        TPKG.Constraint.Fixed(p0.x_id, 0.25),
        TPKG.Constraint.Distance(p0, p1, 3.0),
        TPKG.Constraint.Vertical(TPKG.DatumLineSegment(p0, p1)),
    ], n_vars=4)
    # Lane 0 starts at the solution (0 iterations); lane 1 far away.
    x0s = torch.tensor([[0.25, 1.0, 0.25, 4.0], [0.9, 0.4, -1.2, 2.7]],
                       dtype=torch.float64)
    for precision in ("f64", "mixed"):
        batch = BatchSolver(system, Config(), precision=precision, device="cpu").solve(x0s)
        assert int(batch.iterations[1]) > int(batch.iterations[0])
        for lane in range(2):
            solo = BatchSolver(system, Config(), precision=precision,
                               device="cpu").solve(x0s[lane:lane + 1])
            assert int(batch.iterations[lane]) == int(solo.iterations[0]), (precision, lane)
            assert torch.equal(batch.x[lane], solo.x[0]), (precision, lane)
        if precision == "f64":
            assert int(batch.iterations[0]) == 0
