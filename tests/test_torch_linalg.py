"""The port's batched SPD solve (``ezpz_tpu_torch.ops.linalg.spd_solve``)
against the JAX package's ``spd_solve``, vmapped over the same lanes.

Inputs come from numpy with a fixed seed: per lane a well-conditioned SPD
matrix (eigenvalues in [1, 10]) or an indefinite one (a quarter of its
eigenvalues in [-10, -1]), and a right-hand side in [-1, 1].

What must hold, and why:

* ``fail`` equal lane for lane: the indefinite matrices fail, the SPD ones
  do not, and a NaN entry fails its lane in both packages;
* failed lanes' ``x`` are exactly zero;
* n <= 24 runs the same unrolled Crout in the same order on both sides, so
  x agrees to 1e-12 relative in f64 and 1e-5 in f32 (the slack covers
  XLA's freedom to reassociate inside a fused loop);
* n > 24 is LAPACK's factorization in the port against XLA's in JAX: the
  same algorithm in another operation order, so 1e-9 and 1e-4 relative
  (condition number <= 10).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ezpz_tpu.ops import linalg as JL
from ezpz_tpu_torch.ops import linalg as TL

B = 16
SIZES = [1, 2, 4, 8, 24, 25, 50]


def _matrices(n, seed, nan_lane=None):
    """(A (B, n, n), b (B, n), spd (B,) bool): lanes alternate SPD and
    indefinite (n >= 2; every lane is SPD at n = 1 except the odd lanes,
    which get a negative 1x1)."""
    rng = np.random.default_rng(seed)
    A = np.empty((B, n, n))
    spd = np.arange(B) % 2 == 0
    for k in range(B):
        q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        eig = rng.uniform(1.0, 10.0, n)
        if not spd[k]:
            neg = max(1, n // 4)
            eig[:neg] = -rng.uniform(1.0, 10.0, neg)
        A[k] = (q * eig) @ q.T
        A[k] = 0.5 * (A[k] + A[k].T)
    b = rng.uniform(-1.0, 1.0, (B, n))
    if nan_lane is not None:
        A[nan_lane, n - 1, 0] = np.nan
        A[nan_lane, 0, n - 1] = np.nan
        spd[nan_lane] = False
    return A, b, spd


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", SIZES)
def test_spd_solve_matches_reference(n, dtype):
    A, b, spd = _matrices(n, seed=10 * n + (dtype == "float32"),
                          nan_lane=2 if n > 1 else None)
    run = jax.vmap(JL.spd_solve)
    if n > TL.UNROLL_MAX_N:
        # JAX's tiers above the unrolled size compile faster than they run
        # op by op.
        run = jax.jit(run)
    jx, jfail = run(jnp.asarray(A, dtype), jnp.asarray(b, dtype))
    tdt = getattr(torch, dtype)
    tx, tfail = TL.spd_solve(torch.as_tensor(A, dtype=tdt), torch.as_tensor(b, dtype=tdt))
    tx, tfail = tx.numpy(), tfail.numpy()
    jx, jfail = np.asarray(jx), np.asarray(jfail)
    np.testing.assert_array_equal(tfail, jfail)
    np.testing.assert_array_equal(tfail, ~spd)
    assert (tx[tfail] == 0.0).all()
    if dtype == "float64":
        rtol = 1e-12 if n <= TL.UNROLL_MAX_N else 1e-9
    else:
        rtol = 1e-5 if n <= TL.UNROLL_MAX_N else 1e-4
    ok = ~tfail
    np.testing.assert_allclose(tx[ok], jx[ok], rtol=rtol,
                               atol=rtol * np.abs(jx[ok]).max())


def test_spd_solve_nan_input_fails_every_tier():
    """An all-NaN matrix fails its lane and yields a finite, zero x on both
    tiers; the other lanes are untouched."""
    for n in (3, 30):
        A, b, _spd = _matrices(n, seed=99)
        A[1] = np.nan
        x, fail = TL.spd_solve(torch.as_tensor(A), torch.as_tensor(b))
        assert bool(fail[1]) and not bool(fail[0])
        assert torch.isfinite(x).all() and bool((x[1] == 0).all())


def test_empty_system():
    x, fail = TL.spd_solve(torch.zeros((3, 0, 0)), torch.zeros((3, 0)))
    assert x.shape == (3, 0) and not bool(fail.any())


MULTI_SIZES = [1, 4, 16, 24, 25, 40]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", MULTI_SIZES)
def test_spd_solve_multi_matches_reference(n, dtype):
    """``spd_solve_multi`` (one factorization, r right-hand sides) against
    JAX's, with the tolerances above; and ``spd_solve`` on each column."""
    A, b, spd = _matrices(n, seed=20 * n + (dtype == "float32"),
                          nan_lane=2 if n > 1 else None)
    R = np.random.default_rng(n).uniform(-1.0, 1.0, (B, n, 3))
    R[:, :, 0] = b
    run = jax.vmap(JL.spd_solve_multi)
    if n > TL.UNROLL_MAX_N:
        run = jax.jit(run)
    jx, jfail = run(jnp.asarray(A, dtype), jnp.asarray(R, dtype))
    tdt = getattr(torch, dtype)
    tA = torch.as_tensor(A, dtype=tdt)
    tx, tfail = TL.spd_solve_multi(tA, torch.as_tensor(R, dtype=tdt))
    np.testing.assert_array_equal(tfail.numpy(), np.asarray(jfail))
    np.testing.assert_array_equal(tfail.numpy(), ~spd)
    assert (tx[tfail] == 0.0).all()
    if dtype == "float64":
        rtol = 1e-12 if n <= TL.UNROLL_MAX_N else 1e-9
    else:
        rtol = 1e-5 if n <= TL.UNROLL_MAX_N else 1e-4
    ok = ~tfail.numpy()
    jx = np.asarray(jx)
    np.testing.assert_allclose(tx.numpy()[ok], jx[ok], rtol=rtol,
                               atol=rtol * np.abs(jx[ok]).max())
    col, cfail = TL.spd_solve(tA, torch.as_tensor(b, dtype=tdt))
    assert torch.equal(cfail, tfail)
    torch.testing.assert_close(col, tx[..., 0], rtol=rtol, atol=rtol)


@pytest.mark.parametrize("n", [16, 40])
def test_batched_solves_match_reference(n):
    """The ``_batched`` entry points over two leading axes (parts x lanes,
    as the partitioned-Schur interiors call them) against JAX's vmapped
    twice. Above 24 JAX takes its TPU column-sweep tier and the port the
    library factorization: the n > 24 tolerance."""
    A, b, spd = _matrices(n, seed=30 + n)
    R = np.random.default_rng(n).uniform(-1.0, 1.0, (B, n, 4))
    A2, b2, R2 = A.reshape(4, 4, n, n), b.reshape(4, 4, n), R.reshape(4, 4, n, 4)
    rtol = 1e-12 if n <= TL.UNROLL_MAX_N else 1e-9
    for jfn, tfn, rhs in ((JL.spd_solve_batched, TL.spd_solve_batched, b2),
                          (JL.spd_solve_multi_batched, TL.spd_solve_multi_batched, R2)):
        jx, jfail = jax.jit(jax.vmap(jax.vmap(jfn)))(jnp.asarray(A2), jnp.asarray(rhs))
        tx, tfail = tfn(torch.as_tensor(A2), torch.as_tensor(rhs))
        assert tx.shape == rhs.shape and tfail.shape == (4, 4)
        np.testing.assert_array_equal(tfail.numpy().reshape(-1), ~spd)
        np.testing.assert_array_equal(tfail.numpy(), np.asarray(jfail))
        ok = ~tfail.numpy()
        jx = np.asarray(jx)
        np.testing.assert_allclose(tx.numpy()[ok], jx[ok], rtol=rtol,
                                   atol=rtol * np.abs(jx[ok]).max())


def test_empty_multi_system():
    x, fail = TL.spd_solve_multi(torch.zeros((3, 2, 0, 0)), torch.zeros((3, 2, 0, 5)))
    assert x.shape == (3, 2, 0, 5) and fail.shape == (3, 2) and not bool(fail.any())
