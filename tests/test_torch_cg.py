"""The port's matrix-free LM (``ezpz_tpu_torch.solver.solve_lm_cg``, ``_cg``)
and its compiled-system methods (``jacobian_factors``, ``jtj_matvec``)
against the JAX package on the same seeded numpy inputs.

What must hold, and why:

* ``jacobian_factors`` / ``jtj_matvec``: residual, Jt r, every block's
  weighted Jacobian and JtJ v within 1e-12 of JAX's, and JtJ v within
  1e-12 of the port's own dense JtJ times v (the same products, summed in
  another order);
* ``solve_lm_cg`` on every case of ``tests/test_cg.py`` (and the weighted
  case of ``tests/test_oracle_scipy.py``): converged and iterations
  equal, x within 1e-9 where converged. Both run 1e-12 CG to the same
  budget; their dot products sum in different orders, which CG amplifies
  but a converged LM solve does not carry into x beyond rounding;
* the 600-line ``coupled`` chain (2,400 variables), where 400 CG trips at
  1e-12 cannot resolve 599 links and both packages stop unconverged at
  the budget: flags and iterations equal (x is rounding-dominated there);
* ``_cg``'s warm-start, Krylov and budget contracts against numpy, and
  each lane of a batch stopping where it would alone (bit-equal).
"""

import inspect

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ezpz_tpu import solver as JS
from ezpz_tpu.constraints import Constraint as JConstraint
from ezpz_tpu.datatypes import DatumLineSegment as JLine, DatumPoint as JPoint
from ezpz_tpu.models import compiled as JC
from ezpz_tpu.textual import Problem as JProblem
from ezpz_tpu_torch import solver as TS
from ezpz_tpu_torch.benches.coupled_bench import build_problem, generate_coupled
from ezpz_tpu_torch.constraints import Constraint as TConstraint
from ezpz_tpu_torch.datatypes import DatumLineSegment as TLine, DatumPoint as TPoint
from ezpz_tpu_torch.models import compiled as TC

from .test_torch_frontend import jax_system, port_system

CFG = (35, 1e-8, 1e-12, 1e-9)  # max_iterations, rtol, stol, lambda0
X_TOL = 1e-9
FACTOR_TOL = 1e-12


def _chain(pkg, n_pts=40, seed=5):
    """``tests/test_cg.py``'s chain: fixed start, unit distances,
    horizontal segments, seeded guesses."""
    C, P, L = pkg
    pts = [P(2 * i, 2 * i + 1) for i in range(n_pts)]
    cs = [C.Fixed(pts[0].x_id, 0.0), C.Fixed(pts[0].y_id, 0.0)]
    for i in range(n_pts - 1):
        cs.append(C.Distance(pts[i], pts[i + 1], 1.0))
        cs.append(C.Horizontal(L(pts[i], pts[i + 1])))
    rng = np.random.default_rng(seed)
    x0 = np.zeros(2 * n_pts)
    x0[0::2] = np.arange(n_pts) * 1.05 + rng.uniform(-0.05, 0.05, n_pts)
    x0[1::2] = rng.uniform(-0.2, 0.2, n_pts)
    return cs, x0


JAX = (JConstraint, JPoint, JLine)
PORT = (TConstraint, TPoint, TLine)


def _coupled(lines):
    """(JAX system, port system, x0) of the ``lines``-line coupled chain."""
    cs = JProblem.from_str(generate_coupled(lines)).to_constraint_system()
    jc = [r.constraint for r in cs.constraints]
    tc, x0 = build_problem(lines)
    return JC.compile_system(jc, len(x0)), TC.compile_system(tc, len(x0)), x0


def _jax_cg_solve(system, x0, cfg=CFG):
    return jax.jit(lambda x: JS.solve_lm_cg(system, x, *cfg))(jnp.asarray(x0))


def _port_cg_solve(system, x0s, cfg=CFG):
    return TS.solve_lm_cg(system, torch.as_tensor(np.atleast_2d(x0s)), *cfg)


def _same_solve(port, lane, ref, converged_x=True):
    assert bool(port.converged[lane]) == bool(ref.converged)
    assert int(port.iterations[lane]) == int(ref.iterations)
    if converged_x and bool(ref.converged):
        np.testing.assert_allclose(port.x[lane].numpy(), np.asarray(ref.x),
                                   rtol=0, atol=X_TOL)


# -- jacobian_factors / jtj_matvec ---------------------------------------------

FACTOR_CASES = ["chain", "square", "arc_length", "circle_tangent", "chamfer_square"]


@pytest.mark.parametrize("case", FACTOR_CASES)
def test_jacobian_factors_and_matvec_match_jax(case):
    if case == "chain":
        (jc, x0), (tc, _x) = _chain(JAX, 10), _chain(PORT, 10)
    else:
        (jc, x0), (tc, _x) = jax_system(case), port_system(case)
    js = JC.compile_system(jc, len(x0))
    ts = TC.compile_system(tc, len(x0))
    rng = np.random.default_rng(1)
    x = x0 + rng.normal(0.0, 1e-2, x0.shape)
    jr, jjtr, jw, jdeg = js.jacobian_factors(jnp.asarray(x))
    tr, tjtr, tw, tdeg = ts.jacobian_factors(torch.as_tensor(x)[None])
    np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr), rtol=0, atol=FACTOR_TOL)
    np.testing.assert_allclose(tjtr[0].numpy(), np.asarray(jjtr), rtol=0, atol=FACTOR_TOL)
    np.testing.assert_array_equal(tdeg[0].numpy(), np.asarray(jdeg))
    assert len(tw) == len(jw)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=0, atol=FACTOR_TOL)
    _r, jtj, _jtr, _deg = ts.normal_equations(torch.as_tensor(x)[None])
    for _ in range(3):
        v = rng.normal(size=len(x0))
        got = ts.jtj_matvec(tw, torch.as_tensor(v)[None])[0].numpy()
        np.testing.assert_allclose(got, np.asarray(js.jtj_matvec(jw, jnp.asarray(v))),
                                   rtol=0, atol=FACTOR_TOL)
        np.testing.assert_allclose(got, jtj[0].numpy() @ v, rtol=0, atol=FACTOR_TOL)


def test_jtj_matvec_is_batched_per_lane():
    """A batch of lanes (different points, different vectors) gives each
    lane's own product, bit for bit."""
    tc, x0 = _chain(PORT, 10)
    ts = TC.compile_system(tc, len(x0))
    rng = np.random.default_rng(2)
    xs = torch.as_tensor(x0 + rng.normal(0.0, 1e-2, (4, len(x0))))
    vs = torch.as_tensor(rng.normal(size=(4, len(x0))))
    _r, _jtr, w, _d = ts.jacobian_factors(xs)
    batch = ts.jtj_matvec(w, vs)
    for k in range(4):
        _r1, _jtr1, w1, _d1 = ts.jacobian_factors(xs[k:k + 1])
        assert torch.equal(ts.jtj_matvec(w1, vs[k:k + 1])[0], batch[k])


# -- solve_lm_cg against JAX ---------------------------------------------------


def test_lm_cg_matches_jax_and_dense():
    """``test_cg.py::test_lm_cg_matches_dense``: the 40-point chain."""
    (jc, x0), (tc, _x) = _chain(JAX), _chain(PORT)
    js, ts = JC.compile_system(jc, len(x0)), TC.compile_system(tc, len(x0))
    ref = _jax_cg_solve(js, x0)
    out = _port_cg_solve(ts, x0)
    assert bool(ref.converged)
    _same_solve(out, 0, ref)
    assert float(out.residual.abs().max()) <= 1e-8
    dense = TS.solve_lm(ts, torch.as_tensor(x0)[None], *CFG)
    np.testing.assert_allclose(out.x.numpy(), dense.x.numpy(), rtol=0, atol=1e-7)


def test_cg_damping_sign_matches_jax_at_high_lambda():
    """``test_cg.py::test_cg_damping_sign_matches_dense_at_high_lambda``:
    at lambda0 = 100 the damping dominates the operator JtJ + lambda I."""
    def system(pkg):
        C, P, _L = pkg
        p, q = P(0, 1), P(2, 3)
        return [C.Fixed(0, 0.0), C.Fixed(1, 0.0), C.Fixed(2, 3.0), C.Distance(p, q, 5.0)]
    x0 = np.array([0.1, -0.1, 3.2, 3.6])
    cfg = (35, 1e-8, 1e-12, 100.0)
    ref = _jax_cg_solve(JC.compile_system(system(JAX), 4), x0, cfg)
    ts = TC.compile_system(system(PORT), 4)
    out = _port_cg_solve(ts, x0, cfg)
    _same_solve(out, 0, ref)
    dense = TS.solve_lm(ts, torch.as_tensor(x0)[None], *cfg)
    assert int(dense.iterations[0]) == int(out.iterations[0])


def test_weighted_lm_cg_matches_jax():
    """``test_oracle_scipy.py::test_weighted_inconsistent_matches_scipy``'s
    matrix-free case: Fixed(v, 0) at weight 1 against Fixed(v, 1) at
    weight 3 has its least-squares minimizer at v = 0.9.

    The system is inconsistent, so the solve ends on the step tolerance
    (1e-12), and the trip it ends on follows the last bits of the
    first step. JAX's op-by-op evaluation (``jax.disable_jit``) takes the
    port's operations: the same x bit for bit and the same 15 iterations.
    Jitted, XLA rounds the first step another way (0.8999999999499999
    against 0.89999999995) and step-converges one trip earlier: against
    that run, converged equal, iterations within 1, x within 1e-9."""
    js = JC.compile_system([JConstraint.Fixed(0, 0.0), JConstraint.Fixed(0, 1.0)], 1,
                           weights=[1.0, 3.0])
    ts = TC.compile_system([TConstraint.Fixed(0, 0.0), TConstraint.Fixed(0, 1.0)], 1,
                           weights=[1.0, 3.0])
    out = _port_cg_solve(ts, np.array([0.4]))
    with jax.disable_jit():
        ref = JS.solve_lm_cg(js, jnp.array([0.4]), *CFG)
    _same_solve(out, 0, ref)
    assert float(out.x[0, 0]) == float(ref.x[0])
    jitted = _jax_cg_solve(js, np.array([0.4]))
    assert bool(out.converged[0]) == bool(jitted.converged)
    assert abs(int(out.iterations[0]) - int(jitted.iterations)) <= 1
    np.testing.assert_allclose(float(out.x[0, 0]), float(jitted.x[0]), rtol=0, atol=X_TOL)
    np.testing.assert_allclose(float(out.x[0, 0]), 0.9, atol=1e-7)


def test_coupled_chain_lanes_match_jax():
    """The 200-line ``coupled`` chain (800 variables), four seeded copies
    in one batch: each lane as JAX's solve of that copy (converged in 2
    iterations, max|r| ~1e-13)."""
    js, ts, x0 = _coupled(200)
    x0s = x0 + np.random.default_rng(9).normal(0.0, 1e-3, (4, len(x0)))
    out = _port_cg_solve(ts, x0s)
    run = jax.jit(lambda x: JS.solve_lm_cg(js, x, *CFG))
    for k in range(4):
        ref = run(jnp.asarray(x0s[k]))
        assert bool(ref.converged)
        _same_solve(out, k, ref)
    assert float(out.residual.abs().max()) <= 1e-8


def test_coupled_600_lines_stops_unconverged_as_jax():
    """The 600-line chain: the CG budget (400 trips at 1e-12) cannot
    resolve 599 links, and both packages stop unconverged after the whole
    LM budget (flags and iterations equal)."""
    js, ts, x0 = _coupled(600)
    ref = _jax_cg_solve(js, x0)
    out = _port_cg_solve(ts, x0)
    assert not bool(ref.converged) and int(ref.iterations) == CFG[0]
    _same_solve(out, 0, ref, converged_x=False)


def test_lm_cg_defaults_are_jax_defaults():
    """The inner tolerance and budget default to JAX's (1e-12, 400)."""
    tp = inspect.signature(TS.solve_lm_cg).parameters
    jp = inspect.signature(JS.solve_lm_cg).parameters
    for name in ("cg_tol", "cg_max_iters"):
        assert tp[name].default == jp[name].default
    assert tp["cg_tol"].default == 1e-12 and tp["cg_max_iters"].default == 400


# -- _cg contracts against numpy -----------------------------------------------


def _spd(n, seed, shift):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    A = M @ M.T + shift * np.eye(n)
    return A, rng.standard_normal(n)


def _mv(A):
    """``A v`` per lane, by an elementwise product and a row sum (a
    library matmul rounds differently at different batch sizes)."""
    At = torch.as_tensor(A)
    return lambda v: torch.sum(At[None] * v[:, None, :], dim=-1)


def test_cg_warm_start_contract():
    """``_cg`` honours a nonzero start (r0 = b - A x0): started at the
    solution it stays there; started nearby it still converges."""
    A, b = _spd(4, 3, 4.0)
    xstar = np.linalg.solve(A, b)
    bt = torch.as_tensor(b)[None]
    at = TS._cg(_mv(A), bt, torch.as_tensor(xstar)[None], 1e-13, 50)
    np.testing.assert_allclose(at[0].numpy(), xstar, atol=1e-10)
    near = TS._cg(_mv(A), bt, torch.as_tensor(xstar + 0.1)[None], 1e-13, 50)
    np.testing.assert_allclose(near[0].numpy(), xstar, atol=1e-8)


def test_cg_krylov_efficiency():
    """Exact CG on an SPD 16 x 16 system converges within ~n trips: a
    budget of n + 2 reaches the solution."""
    A, b = _spd(16, 5, 0.5)
    x = TS._cg(_mv(A), torch.as_tensor(b)[None], torch.zeros((1, 16), dtype=torch.float64),
               1e-12, 18)
    np.testing.assert_allclose(x[0].numpy(), np.linalg.solve(A, b), atol=1e-8)


def test_cg_budget_contract():
    """The budget is strict and counted: 0 trips return the start
    untouched; 2 trips do not reach the solution of a 16 x 16 system."""
    A, b = _spd(16, 5, 0.5)
    bt, z = torch.as_tensor(b)[None], torch.zeros((1, 16), dtype=torch.float64)
    assert bool((TS._cg(_mv(A), bt, z, 1e-30, 0) == 0.0).all())
    two = TS._cg(_mv(A), bt, z, 1e-30, 2)
    assert float(np.max(np.abs(two[0].numpy() - np.linalg.solve(A, b)))) > 1e-3


def test_cg_lanes_stop_where_they_would_alone():
    """Per-lane termination: lanes with different budgets and tolerances,
    batched, give each lane's solve alone bit for bit (a finished lane is
    frozen while the others run)."""
    A, b = _spd(16, 7, 0.5)
    rng = np.random.default_rng(8)
    bs = torch.as_tensor(np.stack([b, rng.standard_normal(16), 1e-9 * b, b]))
    tol = torch.tensor([1e-12, 1e-12, 1e-6, 1e-12], dtype=torch.float64)
    iters = torch.tensor([400, 3, 400, 0])
    z = torch.zeros_like(bs)
    batch = TS._cg(_mv(A), bs, z, tol, iters)
    for k in range(4):
        alone = TS._cg(_mv(A), bs[k:k + 1], z[k:k + 1], tol[k:k + 1], iters[k:k + 1])
        assert torch.equal(alone[0], batch[k])
    assert bool((batch[3] == 0).all())


def test_cg_matches_jax_cg():
    """``_cg`` against JAX's ``_cg`` on one SPD system from a warm start:
    within 1e-12 (the same recurrence; dot products in another order)."""
    A, b = _spd(12, 11, 1.0)
    x0 = np.full(12, 0.05)
    ref = JS._cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), jnp.asarray(x0), 1e-12, 40)
    got = TS._cg(_mv(A), torch.as_tensor(b)[None], torch.as_tensor(x0)[None], 1e-12, 40)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), rtol=0, atol=1e-12)
