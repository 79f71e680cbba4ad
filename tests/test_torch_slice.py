"""The whole slice on ``massive_parallel_system`` at M = 1 copy, against
the ``bench.py`` paths in JAX.

Both packages parse the fixture text, build buckets and solve each bucket
from the guesses offset by 11e-9 (bench.py's warm-up offset on a
one-dispatch chain), once per path:

* ``fused``: ``BatchSolver(batch_params=True, precision="mixed",
  pallas_fused=True, pallas_trips=3, refine_trips=2)`` (bench.py's
  default);
* ``coarse``: ``BatchSolver(batch_params=True, precision="mixed",
  pallas_coarse=True, pallas_fused=False, pallas_trips=3)`` (bench.py's
  ``BENCH_FUSED=0``): the coarse kernel, then the batched f64-residual
  refinement.

The JAX side runs its Pallas kernels in interpret mode.

What must hold: the bench gate in both packages (every lane converged and
satisfied, f64 residual <= 1e-8, recomputed outside the solver); equal
degenerate flags; iterations equal or off by one (double-single against
native f64 rounding in the fused refine phase; XLA's fused f32 rounding
against the port's in the coarse path's refine); coordinates within 1e-6
(the fixture is fully constrained); and the solved global vector,
scattered back through ``var_index``, passes the gate on the whole
2400-variable system compiled by the port.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ezpz_tpu.batch import BatchSolver as JBatchSolver
from ezpz_tpu.config import Config as JConfig
from ezpz_tpu.models.blocks import build_buckets as j_build_buckets
from ezpz_tpu.textual import Problem as JProblem
from ezpz_tpu_torch.batch import BatchSolver as TBatchSolver
from ezpz_tpu_torch.config import Config as TConfig
from ezpz_tpu_torch.models.blocks import build_buckets as t_build_buckets
from ezpz_tpu_torch.models.compiled import compile_system
from ezpz_tpu_torch.textual import Problem as TProblem

from .test_torch_frontend import fixture_text

OFFSET = 11e-9
PATHS = {
    "fused": dict(batch_params=True, precision="mixed", pallas_fused=True,
                  pallas_trips=3, refine_trips=2),
    "coarse": dict(batch_params=True, precision="mixed", pallas_coarse=True,
                   pallas_fused=False, pallas_trips=3),
}


def _guesses(cs):
    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val
    return x0


@pytest.fixture(scope="module", params=list(PATHS))
def slice_runs(request):
    args = PATHS[request.param]
    txt = fixture_text("massive_parallel_system")
    tcs = TProblem.from_str(txt).to_constraint_system()
    jcs = JProblem.from_str(txt).to_constraint_system()
    x0 = _guesses(tcs)
    np.testing.assert_array_equal(x0, _guesses(jcs))
    tcons = [r.constraint for r in tcs.constraints]
    tbk = t_build_buckets(tcons, len(x0))
    jbk = j_build_buckets([r.constraint for r in jcs.constraints], len(x0))
    runs = []
    for tb, jb in zip(tbk, jbk):
        xb = x0[tb.var_index] + OFFSET
        jout = JBatchSolver(jb.system, JConfig(), **args).solve(
            jnp.asarray(xb), tuple(jnp.asarray(p) for p in jb.pars))
        tpars = tuple(torch.as_tensor(p) for p in tb.pars)
        tout = TBatchSolver(tb.system, TConfig(), device="cpu", **args).solve(
            torch.as_tensor(xb), tpars)
        r, _deg = tb.system.residual_and_flags(tout.x, tpars)
        jr, _ = jax.vmap(lambda x, *p: jb.system.residual_and_flags(x, p))(
            jnp.asarray(jout.x), *[jnp.asarray(p) for p in jb.pars])
        runs.append((tb, jout, tout, r.numpy(), np.asarray(jr)))
    return tcons, x0, runs


def test_bucket_shapes(slice_runs):
    _tcons, _x0, runs = slice_runs
    assert [(tb.system.n_vars, len(tb.components)) for tb, *_ in runs] == [
        (1, 1200), (2, 600)]


def test_bench_gate_in_both_packages(slice_runs):
    _tcons, _x0, runs = slice_runs
    for _tb, jout, tout, r, jr in runs:
        assert bool(np.asarray(jout.converged).all())
        assert bool(np.asarray(jout.satisfied).all())
        assert bool(tout.converged.all()) and bool(tout.satisfied.all())
        assert np.abs(r).max() <= 1e-8
        assert np.abs(jr).max() <= 1e-8


def test_flags_iterations_and_coordinates_match(slice_runs):
    _tcons, _x0, runs = slice_runs
    for _tb, jout, tout, _r, _jr in runs:
        np.testing.assert_array_equal(tout.degenerate.numpy(), np.asarray(jout.degenerate))
        it_t = tout.iterations.numpy().astype(int)
        it_j = np.asarray(jout.iterations).astype(int)
        assert np.abs(it_t - it_j).max() <= 1
        np.testing.assert_allclose(tout.x.numpy(), np.asarray(jout.x), atol=1e-6)


def test_global_vector_passes_gate(slice_runs):
    tcons, x0, runs = slice_runs
    x = x0.copy()
    for tb, _jout, tout, _r, _jr in runs:
        x[tb.var_index.reshape(-1)] = tout.x.numpy().reshape(-1)
    system = compile_system(tcons, len(x0))
    r, deg = system.residual_and_flags(torch.as_tensor(x)[None])
    assert float(r.abs().max()) <= 1e-8
    assert not bool(deg.any())
    assert bool(system.satisfaction_from_residual(r).all())
