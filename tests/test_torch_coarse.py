"""The coarse fleet solver and the coarse path against the JAX package.

1. ``coarse_fleet_reference`` (the CUDA kernel's plain version) against the
   JAX coarse Pallas kernel (``make_coarse_fleet_solver``), run as
   ``tests/test_unrolled_pallas.py`` runs it: through
   ``BatchSolver(..., pallas_coarse=True)`` on the CPU, in interpret mode.
   The solver's cached kernel run (``_pallas_runs[1024]``) is then called
   on the same inputs for the raw coarse outputs (x, iterations,
   degenerate), without a second compile.
2. ``BatchSolver(pallas_coarse=True, pallas_fused=False, device="cpu")``
   (coarse kernel, then the batched ``solve_lm_refine``) against the JAX
   ``BatchSolver(pallas_coarse=True)``, from the same JAX run.
3. The plain ``BatchSolver`` modes (``precision`` "f64" and "mixed",
   ``batch_params`` True and False) against the JAX ``BatchSolver`` with
   the same precision, and ``finish_stragglers`` against the JAX
   ``BatchSolver`` with the same flags.

Inputs: B = 1024 seeded perturbations (sigma 1e-3) of each fixture's
guesses, shared by both packages; stragglers come from a far start
(sigma 0.5) of ``square`` with its 4 coarse trips (71 of 1024 lanes).

Cost: each JAX solver compiles once (interpret-mode kernel, jitted
refinement). The straggler test reuses the ``square`` case's solver; the
plain modes share one JAX run per bucket and precision.

What must hold, and why:

* coarse kernel: iterations, converged and degenerate equal lane for lane;
  x within ``rtol=atol=1e-5`` on fully constrained cases (f32 in both,
  XLA's fused rounding against the port's op-by-op rounding; on the
  under-constrained ``parc_coincident`` the f32 points drift apart along the
  free directions, up to 0.075, as ROADMAP.md's rule on coordinates
  expects). The JAX kernel's converged flag is not
  among the solver's outputs; it is derived from its iterations and its
  coarse point: converged iff iterations < trips, or the f32 residual at
  the coarse point is within the lane's tolerance;
* paths: flags equal on lanes without a NaN residual row; iterations equal
  or off by one, and equal on >= 99% of lanes of fully constrained cases
  (f32 phases round differently). On ``parc_coincident`` the f32 steps
  against a singular JtJ amplify that rounding: over seeds 0-11 of these
  inputs, 1 to 11 of 1024 lanes differ by one (99.90% to 98.93% equal; the
  lowest, 98.93%, on seed 3, the one used here; every other seed >= 99.02%),
  flags always equal, so under-constrained cases need >= 98%. x within
  1e-6 on fully constrained cases where both converged; f64 residual
  <= 1e-8 wherever a package converged;
* stragglers: the merged lanes equal the port's plain mixed path on the
  same lanes exactly, and the merged result agrees with JAX's as above.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ezpz_tpu.batch import BatchSolver as JBatchSolver
from ezpz_tpu.config import Config as JConfig
from ezpz_tpu.models import blocks as JB
from ezpz_tpu_torch.batch import BatchSolver as TBatchSolver
from ezpz_tpu_torch.config import Config as TConfig
from ezpz_tpu_torch.models import blocks as TB
from ezpz_tpu_torch.ops import coarse_fleet

from .test_torch_frontend import jax_system, port_system

B = 1024
FIELDS = ("x", "iterations", "converged", "satisfied", "degenerate")
# (fixture, bucket index, coarse trips, fully constrained)
CASES = [
    ("massive_parallel_system", 0, 3, True),
    ("massive_parallel_system", 1, 3, True),
    ("square", 0, 4, True),
    ("parc_coincident", 0, 4, False),
]
IDS = [f"{c[0]}[{c[1]}]" for c in CASES]
# (fixture, bucket index, fully constrained) for the plain modes: one
# component each, so every lane has the bucket's own parameters and both
# ``batch_params`` settings see the same inputs.
PLAIN = [("chamfer_square", 0, True), ("circle_tangent", 0, True)]
PLAIN_MODES = [("f64", True), ("f64", False), ("mixed", True), ("mixed", False)]


def _buckets(name, bi):
    tc, x0 = port_system(name)
    jc, _ = jax_system(name)
    return TB.build_buckets(tc, len(x0))[bi], JB.build_buckets(jc, len(x0))[bi], x0


def _inputs(bucket, x0, seed, sigma=1e-3):
    """B lanes cycling over the bucket's components, guesses perturbed."""
    rng = np.random.default_rng(seed)
    k = np.arange(B) % len(bucket.components)
    xb = x0[bucket.var_index[k]] + rng.normal(0, sigma, (B, bucket.var_index.shape[1]))
    return xb, [np.asarray(p)[k] for p in bucket.pars]


def _residuals(system, x, pars):
    r, _deg = system.residual_and_flags(torch.as_tensor(np.array(x)),
                                        tuple(torch.as_tensor(p) for p in pars))
    return r.numpy()


def _outcome(res):
    return {k: np.asarray(getattr(res, k)) for k in FIELDS}


@pytest.fixture(scope="module")
def runs():
    """Both packages' coarse kernel and coarse path on every case."""
    out = {}
    for seed, (name, bi, trips, full) in enumerate(CASES):
        tb, jb, x0 = _buckets(name, bi)
        xb, pars = _inputs(tb, x0, seed)
        js = JBatchSolver(jb.system, JConfig(), batch_params=True,
                          precision="mixed", pallas_coarse=True, pallas_trips=trips)
        jpars = tuple(jnp.asarray(p) for p in pars)
        jout = js.solve(jnp.asarray(xb), jpars)
        kernel = js._pallas_runs[B]
        assert kernel is not None, "JAX must take its coarse kernel"
        jx1, jits, jdeg = kernel(jnp.asarray(xb), jpars)
        ts = TBatchSolver(tb.system, TConfig(), batch_params=True,
                          precision="mixed", pallas_coarse=True, pallas_trips=trips,
                          device="cpu")
        tpars = tuple(torch.as_tensor(p) for p in pars)
        tcoarse = coarse_fleet.coarse_fleet_reference(
            ts.plan, torch.as_tensor(xb), tpars, **ts.coarse_settings())
        tout = ts.solve(xb, pars)
        out[f"{name}[{bi}]"] = dict(
            full=full, trips=trips, system=tb.system, jsolver=js, xb=xb, pars=pars,
            jcoarse=(np.array(jx1), np.array(jits), np.array(jdeg)),
            tcoarse=tuple(t.numpy() for t in tcoarse),
            j=_outcome(jout), t=_outcome(tout),
            jr=_residuals(tb.system, jout.x, pars), tr=_residuals(tb.system, tout.x, pars),
        )
    return out


def _jax_coarse_converged(run):
    """The JAX coarse kernel's converged flag, from its iterations and its
    coarse point (pallas_fleet.py:753-759): a lane that stopped before the
    last trip converged; one that used every trip converged iff its f32
    residual is within max(5e-6, 1e-7 * max(1, |x0|_inf))."""
    x1, its, _deg = run["jcoarse"]
    sys32 = run["system"].astype(torch.float32)
    r, _ = sys32.residual_and_flags(torch.as_tensor(x1),
                                    tuple(torch.as_tensor(p).float() for p in run["pars"]))
    x0 = run["xb"].astype(np.float32)
    scale = np.maximum(np.float32(1.0), np.abs(x0).max(axis=1))
    tol = np.maximum(np.float32(5e-6), np.float32(1e-7) * scale)
    within = np.abs(r.numpy()).max(axis=1) <= tol
    return (its < run["trips"]) | within


@pytest.mark.parametrize("case", IDS)
def test_coarse_kernel_plain_version_matches_jax_kernel(runs, case):
    run = runs[case]
    jx1, jits, jdeg = run["jcoarse"]
    tx1, tits, tconv, tdeg = run["tcoarse"]
    assert tx1.dtype == np.float32 and tits.dtype == np.int32
    np.testing.assert_array_equal(tits, jits)
    np.testing.assert_array_equal(tdeg, jdeg)
    np.testing.assert_array_equal(tconv, _jax_coarse_converged(run))
    if run["full"]:
        np.testing.assert_allclose(tx1, jx1, rtol=1e-5, atol=1e-5)


def _assert_paths_agree(j, t, jr, tr, full):
    clean = ~(np.isnan(jr).any(axis=1) | np.isnan(tr).any(axis=1))
    assert clean.mean() > 0.99
    for k in ("converged", "satisfied", "degenerate"):
        np.testing.assert_array_equal(t[k][clean], j[k][clean], err_msg=k)
    diff = np.abs(t["iterations"].astype(int) - j["iterations"].astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= (0.99 if full else 0.98)
    assert j["converged"].mean() > 0.9
    assert np.abs(jr[j["converged"]]).max() <= 1e-8
    assert np.abs(tr[t["converged"]]).max() <= 1e-8
    if full:
        both = t["converged"] & j["converged"]
        np.testing.assert_allclose(t["x"][both], j["x"][both], rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", IDS)
def test_coarse_path_matches_jax(runs, case):
    run = runs[case]
    _assert_paths_agree(run["j"], run["t"], run["jr"], run["tr"], run["full"])


@pytest.mark.parametrize("case", IDS)
def test_cpu_wrapper_takes_plain_version(runs, case):
    """On CPU tensors ``coarse_fleet_solve`` is exactly the plain version
    and launches nothing."""
    run = runs[case]
    solver = TBatchSolver(run["system"], TConfig(), batch_params=True,
                          precision="mixed", pallas_coarse=True,
                          pallas_trips=run["trips"], device="cpu")
    x0 = torch.as_tensor(run["xb"][:64])
    pars = tuple(torch.as_tensor(p[:64]) for p in run["pars"])
    before = coarse_fleet.LAUNCHES
    got = coarse_fleet.coarse_fleet_solve(solver.plan, x0, pars, **solver.coarse_settings())
    want = coarse_fleet.coarse_fleet_reference(solver.plan, x0, pars, **solver.coarse_settings())
    assert coarse_fleet.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def plain_runs():
    """One JAX ``BatchSolver(batch_params=False)`` run per plain bucket and
    precision, shared by both ``batch_params`` settings of the port (the
    buckets have one component, so the inputs are the same)."""
    out = {}
    for name, bi, _full in PLAIN:
        tb, jb, x0 = _buckets(name, bi)
        xb, pars = _inputs(tb, x0, seed=7)
        assert all((p == b.par).all() for p, b in zip(pars, tb.system.blocks))
        for precision in ("f64", "mixed"):
            js = JBatchSolver(jb.system, JConfig(), batch_params=False, precision=precision)
            jout = js.solve(jnp.asarray(xb))
            out[name, bi, precision] = (tb, xb, pars, _outcome(jout),
                                        _residuals(tb.system, jout.x, pars))
    return out


@pytest.mark.parametrize("mode", PLAIN_MODES, ids=[f"{p}-batch_params={b}" for p, b in PLAIN_MODES])
@pytest.mark.parametrize("case", PLAIN, ids=[f"{n}[{b}]" for n, b, _f in PLAIN])
def test_plain_modes_match_jax(plain_runs, case, mode):
    name, bi, full = case
    precision, batch_params = mode
    tb, xb, pars, j, jr = plain_runs[name, bi, precision]
    ts = TBatchSolver(tb.system, TConfig(), batch_params=batch_params,
                      precision=precision, device="cpu")
    tout = ts.solve(xb, pars) if batch_params else ts.solve(xb)
    _assert_paths_agree(j, _outcome(tout), jr, _residuals(tb.system, tout.x, pars), full)


def test_finish_stragglers_matches_jax_and_plain_mixed(runs):
    """Reuses the ``square`` case's JAX solver, whose coarse kernel is
    already compiled."""
    run = runs["square[0]"]
    tb, _jb, x0 = _buckets("square", 0)
    xb, pars = _inputs(tb, x0, seed=11, sigma=0.5)
    kw = dict(batch_params=True, precision="mixed", pallas_coarse=True,
              pallas_trips=run["trips"])
    ts = TBatchSolver(tb.system, TConfig(), device="cpu", **kw)
    rough = ts.solve(xb, pars)
    stragglers = ~rough.converged.numpy()
    assert 10 <= stragglers.sum() <= B // 2, "the far start must leave some lanes unconverged"
    tout = ts.solve(xb, pars, finish_stragglers=True)
    plain = TBatchSolver(tb.system, TConfig(), batch_params=True, precision="mixed",
                         device="cpu").solve(xb[stragglers], [p[stragglers] for p in pars])
    for k in FIELDS:
        got = getattr(tout, k).numpy()
        np.testing.assert_array_equal(got[stragglers], getattr(plain, k).numpy(), err_msg=k)
        np.testing.assert_array_equal(got[~stragglers], getattr(rough, k).numpy()[~stragglers],
                                      err_msg=k)
    js = run["jsolver"]
    jout = js.solve(jnp.asarray(xb), tuple(jnp.asarray(p) for p in pars),
                    finish_stragglers=True)
    assert js._pallas_runs[B] is not None
    _assert_paths_agree(_outcome(jout), _outcome(tout), _residuals(tb.system, jout.x, pars),
                        _residuals(tb.system, tout.x, pars), full=True)
