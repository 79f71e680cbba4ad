"""The port's 23 residual kernels (ezpz_tpu_torch.ops.kernels) against the
JAX package's (ezpz_tpu.ops.kernels): registry, values in f64 and f32,
degenerate flags, and forward-mode Jacobians against ``jax.jacfwd``.

Inputs come from numpy with fixed seeds and go to both packages.
Tolerances:

* f64 values: 1e-12 absolute + relative. Both sides run the same IEEE
  operations in the same order; the slack covers XLA:CPU's freedom to
  contract or reassociate inside a fused loop and its own sin/cos.
* f32 values: 2e-5 relative + absolute (a few f32 ulps of the O(1-100)
  intermediates the kernels cancel).
* Jacobians (f64): 1e-9 relative + absolute — forward-mode rules differ
  between the frameworks by rounding only (e.g. t/(2*sqrt) against
  t*(0.5/sqrt)).
* degenerate flags: exactly equal.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ezpz_tpu.ops import kernels as JK
from ezpz_tpu_torch.ops import kernels as TK

NAMES = sorted(JK.KERNELS)


def test_registry_matches_reference():
    assert list(TK.KERNELS) == list(JK.KERNELS)
    for name, spec in JK.KERNELS.items():
        t = TK.KERNELS[name]
        assert (t.name, t.nvars, t.nparams, t.dim, t.can_degenerate) == (
            spec.name, spec.nvars, spec.nparams, spec.dim, spec.can_degenerate)
    assert TK.KIND_ID == {n: i for i, n in enumerate(JK.KERNELS)}


def _jax_fn(name):
    """The JAX kernel the fused TPU kernel runs (atan2-free point-arc)."""
    return JK.PALLAS_SAFE_FN.get(name, JK.KERNELS[name].fn)


def _inputs(name, rng, size=64):
    spec = JK.KERNELS[name]
    v = rng.uniform(-50.0, 50.0, (spec.nvars, size))
    p = rng.uniform(0.5, 20.0, (spec.nparams, size))
    if name in ("lines_at_angle", "points_at_angle"):
        th = rng.uniform(-np.pi, np.pi, size)
        p = np.stack([np.sin(th), np.cos(th)])
    if name == "line_tangent_circle":
        p = np.where(rng.random((1, size)) < 0.5, -1.0, 1.0)
    if name == "circle_tangent_circle":
        p = np.where(rng.random((1, size)) < 0.5, 0.0, 1.0)
    return v, p


def _degenerate_inputs(name, rng, size=64):
    """Inputs where every segment/radius the kernel measures is (near)
    zero-length: all variables equal up to a 1e-6 jitter, which is below
    every degeneracy threshold (EPSILON^2 on squared lengths)."""
    v, p = _inputs(name, rng, size)
    base = rng.uniform(-5.0, 5.0, size)
    v = base[None, :] + rng.uniform(-1e-6, 1e-6, v.shape)
    return v, p


@functools.lru_cache(maxsize=None)
def _jax_values(name):
    return jax.jit(jax.vmap(_jax_fn(name)))


@functools.lru_cache(maxsize=None)
def _jax_jacobian(name):
    fn = _jax_fn(name)
    return jax.jit(jax.vmap(jax.jacfwd(lambda vv, pp: fn(vv, pp)[0])))


def _run_jax(name, v, p, dtype):
    res, deg = _jax_values(name)(jnp.asarray(v.T, dtype), jnp.asarray(p.T, dtype))
    return np.asarray(res), np.asarray(deg)


def _run_torch(name, v, p, dtype):
    fn = TK.KERNELS[name].fn
    res, deg = fn(list(torch.as_tensor(v, dtype=dtype)),
                  list(torch.as_tensor(p, dtype=dtype)))
    return res.T.numpy(), deg.numpy()


@pytest.mark.parametrize("name", NAMES)
def test_values_f64(name):
    rng = np.random.default_rng(100 + NAMES.index(name))
    v, p = _inputs(name, rng)
    jr, jd = _run_jax(name, v, p, jnp.float64)
    tr, td = _run_torch(name, v, p, torch.float64)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(tr, jr, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_values_f32(name):
    rng = np.random.default_rng(200 + NAMES.index(name))
    v, p = _inputs(name, rng)
    v = v.astype(np.float32).astype(np.float64)
    jr, jd = _run_jax(name, v, p, jnp.float32)
    tr, td = _run_torch(name, v, p, torch.float32)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(tr, jr, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", [n for n in NAMES if JK.KERNELS[n].can_degenerate])
def test_degenerate_inputs(name):
    """At degenerate configurations both packages flag the same lanes and
    return the same (guarded) residual values, with no NaN."""
    rng = np.random.default_rng(300 + NAMES.index(name))
    v, p = _degenerate_inputs(name, rng)
    jr, jd = _run_jax(name, v, p, jnp.float64)
    tr, td = _run_torch(name, v, p, torch.float64)
    assert td.any(), "the probe must hit the degenerate branch"
    np.testing.assert_array_equal(td, jd)
    assert np.isfinite(tr).all()
    np.testing.assert_allclose(tr, jr, rtol=1e-12, atol=1e-12)


def _torch_jacobian(name, v, p):
    """(size, dim, nvars) columns by torch.func.jvp with one-hot tangents —
    the construction the fused plain version uses."""
    fn = TK.KERNELS[name].fn
    vt = tuple(torch.as_tensor(v))
    pt = list(torch.as_tensor(p))
    cols = []
    for a in range(len(vt)):
        tangent = tuple(torch.ones_like(x) if r == a else torch.zeros_like(x)
                        for r, x in enumerate(vt))
        _res, dres = torch.func.jvp(lambda *vv: fn(vv, pt)[0], vt, tangent)
        cols.append(dres.numpy())  # (dim, size)
    return np.stack(cols, axis=-1).transpose(1, 0, 2)


@pytest.mark.parametrize("name", NAMES)
def test_jvp_jacobian_matches_jacfwd(name):
    rng = np.random.default_rng(400 + NAMES.index(name))
    v, p = _inputs(name, rng, size=64)
    jj = np.asarray(_jax_jacobian(name)(jnp.asarray(v.T), jnp.asarray(p.T)))
    tj = _torch_jacobian(name, v, p)
    np.testing.assert_allclose(tj, jj, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", [n for n in NAMES if JK.KERNELS[n].can_degenerate])
def test_degenerate_jacobian_is_finite_and_matches(name):
    """The guards keep NaN out of the tangents: degenerate lanes give the
    JAX kernel's (zero or finite) Jacobian rows."""
    rng = np.random.default_rng(500 + NAMES.index(name))
    v, p = _degenerate_inputs(name, rng, size=64)
    jj = np.asarray(_jax_jacobian(name)(jnp.asarray(v.T), jnp.asarray(p.T)))
    tj = _torch_jacobian(name, v, p)
    assert np.isfinite(tj).all()
    np.testing.assert_allclose(tj, jj, rtol=1e-9, atol=1e-9)


def test_ccw_angle_less_matches_reference():
    """The atan2-free span classification agrees with the JAX helper,
    including the exact-boundary tie-breaks it documents."""
    rng = np.random.default_rng(8)
    args = rng.standard_normal((6, 4096))
    want = np.asarray(JK.ccw_angle_less(*map(jnp.asarray, args)))
    got = TK.ccw_angle_less(*map(torch.as_tensor, args)).numpy()
    np.testing.assert_array_equal(got, want)
    for case in ((1, 1, 2, 2, -1, 1), (1, 1, -3, -3, 0, 1), (1, 0, 0, 2, 0, 1)):
        want = bool(JK.ccw_angle_less(*[jnp.asarray(float(a)) for a in case]))
        got = bool(TK.ccw_angle_less(*[torch.tensor(float(a)) for a in case]))
        assert got == want, case
