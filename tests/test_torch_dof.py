"""The port's freedom (DoF) analysis against the JAX package's, on the CPU.

``freedom_analysis`` (host numpy), ``participation_device`` (one batched
SVD on the tensor's device) and ``freedom_analysis_batch`` on the
threshold cases of ``tests/test_batch_dof.py``: underconstrained lists
exactly equal, participations within 1e-12. ``BatchSolver.solve_analysis``
against JAX's on an underconstrained and a well-constrained bucket (f64
and mixed): underconstrained lists equal lane for lane.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ezpz_tpu import dof as JD
from ezpz_tpu.batch import BatchSolver as JBatchSolver
from ezpz_tpu.config import Config as JConfig
from ezpz_tpu.constraints import Constraint as JConstraint
from ezpz_tpu.datatypes import DatumPoint as JDatumPoint
from ezpz_tpu.models.compiled import compile_system as j_compile_system
from ezpz_tpu_torch import dof as TD
from ezpz_tpu_torch.batch import BatchSolver as TBatchSolver
from ezpz_tpu_torch.config import Config as TConfig
from ezpz_tpu_torch.constraints import Constraint as TConstraint
from ezpz_tpu_torch.datatypes import DatumPoint as TDatumPoint
from ezpz_tpu_torch.models.compiled import compile_system as t_compile_system
from ezpz_tpu_torch.utils.errors import EmptySystemNotAllowed


def _threshold_cases():
    """The Jacobians of tests/test_batch_dof.py's threshold cases."""
    rng = np.random.default_rng(7)
    base = rng.standard_normal((6, 5, 7))
    base[:, :, 4] = 0.0  # rank-deficient beyond the m < n structural one
    eps = 1.7e-3
    return {
        "decade_kept": np.diag([1.0, 3e-8]),
        "decade_cut": np.diag([1.0, 3e-9]),
        "relative_cut": np.diag([100.0, 1e-8]),
        "participation_in": np.asarray([[1.0, 3e-3, 0.0]]),
        "participation_out": np.asarray([[1.0, 3e-4, 0.0]]),
        "relative_participation": np.asarray([[1.0, -1.0, 0.0, 0.0],
                                              [0.0, 1.0, -1.0, 0.0],
                                              [eps, 0.0, 0.0, 1.0]]),
        "zero": np.zeros((2, 3)),
        "wide_random": base,
        "tall": np.asarray([[1.0, 0.0], [0.0, 1e-9], [0.0, 2e-9]]),
    }


CASES = _threshold_cases()


def _batch(j):
    return j if j.ndim == 3 else j[None]


@pytest.mark.parametrize("name", sorted(CASES))
def test_freedom_analysis_matches_jax(name):
    for j in _batch(CASES[name]):
        assert TD.freedom_analysis(j).underconstrained() == \
            JD.freedom_analysis(j).underconstrained()


@pytest.mark.parametrize("name", sorted(CASES))
def test_participation_device_matches_jax(name):
    jb = _batch(CASES[name])
    tp, tn = TD.participation_device(torch.as_tensor(jb))
    jp, jn = jax.vmap(JD.participation_device)(jnp.asarray(jb))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tp.shape == (jb.shape[0], jb.shape[2])


@pytest.mark.parametrize("name", sorted(CASES))
def test_freedom_analysis_batch_matches_jax_and_host(name):
    jb = _batch(CASES[name])
    got = [a.underconstrained() for a in TD.freedom_analysis_batch(jb, device="cpu")]
    assert got == [a.underconstrained() for a in JD.freedom_analysis_batch(jb)]
    assert got == [TD.freedom_analysis(j).underconstrained() for j in jb]


def test_threshold_pins():
    """The thresholds of find_dof.rs through the port's batched path: the
    rank cut is 1e-8 relative, the participation cut 1e-3 relative, and an
    all-zero Jacobian leaves every variable free."""
    def batch(name):
        return [a.underconstrained() for a in
                TD.freedom_analysis_batch(_batch(CASES[name]), device="cpu")]

    assert batch("decade_kept") == [[]]
    assert batch("decade_cut") == [[1]]
    assert batch("relative_cut") == [[1]]
    assert batch("participation_in") == [[0, 1, 2]]
    assert batch("participation_out") == [[1, 2]]
    assert batch("relative_participation") == [[0, 1, 2, 3]]
    assert batch("zero") == [[0, 1, 2]]


def test_empty_jacobian_raises():
    with pytest.raises(EmptySystemNotAllowed):
        TD.freedom_analysis_batch(np.zeros((2, 0, 4)), device="cpu")
    with pytest.raises(EmptySystemNotAllowed):
        TD.freedom_analysis(np.zeros((0, 3)))


def _systems(kind):
    """(JAX system, port system, x0 (B, 4)) of tests/test_batch_dof.py's
    buckets: p on a circle around a fixed q (2 underconstrained
    variables), or everything pinned."""
    out = []
    for C, P, compile_system in ((JConstraint, JDatumPoint, j_compile_system),
                                 (TConstraint, TDatumPoint, t_compile_system)):
        p, q = P(0, 1), P(2, 3)
        if kind == "under":
            cs = [C.Fixed(2, 0.0), C.Fixed(3, 0.0), C.Distance(p, q, float(np.sqrt(2.0)))]
        else:
            cs = [C.Fixed(0, 0.0), C.Fixed(1, 0.0), C.Fixed(2, 3.0), C.Distance(p, q, 5.0)]
        out.append(compile_system(cs, 4))
    rng = np.random.default_rng(0)
    x0 = np.zeros((16, 4))
    if kind == "under":
        x0[:, :2] = rng.uniform(0.5, 2.0, (16, 2))
    else:
        x0[:, 2] = 3.0 + np.arange(16) * 0.1
        x0[:, 3] = 3.5
    return out[0], out[1], x0


@pytest.mark.parametrize("kind", ["under", "well"])
@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_batch_solve_analysis_matches_jax(kind, precision):
    jsys, tsys, x0 = _systems(kind)
    jres, jan = JBatchSolver(jsys, JConfig(), precision=precision).solve_analysis(
        jnp.asarray(x0))
    tres, tan = TBatchSolver(tsys, TConfig(), precision=precision,
                             device="cpu").solve_analysis(x0)
    assert bool(tres.converged.all()) and bool(np.asarray(jres.converged).all())
    assert [a.underconstrained() for a in tan] == [a.underconstrained() for a in jan]
    want = [0, 1] if kind == "under" else []
    assert all(a.underconstrained() == want for a in tan)
    # The host analysis of each solved point agrees (loop equivalence).
    for i, a in enumerate(tan):
        j = tsys.jacobian_dense(tres.x[i:i + 1])[0].numpy()
        assert TD.freedom_analysis(j).underconstrained() == a.underconstrained()


def test_batch_solve_analysis_with_per_sketch_parameters():
    """``batch_params=True``: the Jacobians take each sketch's parameters."""
    _jsys, tsys, x0 = _systems("well")
    pars = tuple(np.tile(b.par, (16, 1, 1)) for b in tsys.blocks)
    res, an = TBatchSolver(tsys, TConfig(), batch_params=True,
                           device="cpu").solve_analysis(x0, pars)
    assert bool(res.converged.all())
    assert all(not a.is_underconstrained() for a in an)


def test_batch_solve_analysis_refuses_an_empty_system():
    system = t_compile_system([], 2)
    with pytest.raises(EmptySystemNotAllowed):
        TBatchSolver(system, TConfig(), device="cpu").solve_analysis(np.zeros((2, 2)))
