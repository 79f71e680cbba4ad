"""The port's Gauss-Newton (``ezpz_tpu_torch.solver.solve_gauss_newton``)
against the JAX package's, on every Gauss-Newton case of
``tests/test_solver_edges.py`` and on batches that mix them.

What must hold: converged, iterations and degenerate flags equal, x within
1e-10 (the same damped normal equations and unrolled Crout on both sides,
summed in the same order up to rounding). The semantics pinned: no
accept/reject; a failed factorization neither steps nor counts as step
convergence; the iteration count does not advance on the trip where the
residual has converged; a strict budget; inclusive residual and step
checks; the final residual and flags evaluated once, after the loop.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ezpz_tpu import solver as JS
from ezpz_tpu.constraints import Constraint as JConstraint
from ezpz_tpu.datatypes import DatumPoint as JPoint
from ezpz_tpu.models import compiled as JC
from ezpz_tpu_torch import solver as TS
from ezpz_tpu_torch.constraints import Constraint as TConstraint
from ezpz_tpu_torch.datatypes import DatumPoint as TPoint
from ezpz_tpu_torch.models import compiled as TC

from .test_torch_cg import _coupled

X_TOL = 1e-10


def _pinned_distance(C, P):
    """Fixed x, y of p and x of q, |pq| = 5: q = (3, +-4)."""
    p, q = P(0, 1), P(2, 3)
    return [C.Fixed(0, 0.0), C.Fixed(1, 0.0), C.Fixed(2, 3.0), C.Distance(p, q, 5.0)]


def _lone_distance(C, P):
    """Only |pq| = 4: JtJ is rank 1 on 4 variables (singular at lambda 0)."""
    return [C.Distance(P(0, 1), P(2, 3), 4.0)]


def _fixed(C, P):
    return [C.Fixed(0, 3.0)]


SYSTEMS = {"pinned_distance": (_pinned_distance, 4), "lone_distance": (_lone_distance, 4),
           "fixed": (_fixed, 1)}


def _systems(name):
    build, n = SYSTEMS[name]
    return (JC.compile_system(build(JConstraint, JPoint), n),
            TC.compile_system(build(TConstraint, TPoint), n))


def _check(out, lane, ref):
    assert bool(out.converged[lane]) == bool(ref.converged)
    assert int(out.iterations[lane]) == int(ref.iterations)
    np.testing.assert_array_equal(out.deg[lane].numpy(), np.asarray(ref.deg))
    np.testing.assert_allclose(out.x[lane].numpy(), np.asarray(ref.x), rtol=0, atol=X_TOL)
    np.testing.assert_allclose(out.residual[lane].numpy(), np.asarray(ref.residual),
                               rtol=0, atol=X_TOL)


# (system, x0, max_iterations, rtol, stol, lambda0), each a case of
# tests/test_solver_edges.py.
CASES = {
    # test_gauss_newton_factorization_failure_not_converged
    "factorization_failure": ("lone_distance", [0.0, 0.0, 1.0, 0.0], 5, 1e-8, 1e-12, 0.0),
    # test_gauss_newton_solves_nonlinear_system
    "solves_nonlinear": ("pinned_distance", [0.1, -0.1, 3.2, 3.6], 35, 1e-8, 1e-12, 1e-9),
    # test_step_tolerance_boundary_is_inclusive (d = 7 exactly at stol 7)
    "step_tolerance_inclusive": ("fixed", [10.0], 5, 1e-8, 7.0, 0.0),
    # test_gauss_newton_budget_is_strict
    "budget_is_strict": ("pinned_distance", [0.1, -0.1, 3.2, 3.6], 1, 1e-8, 1e-12, 1e-9),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gauss_newton_matches_jax(case):
    name, x0, *cfg = CASES[case]
    js, ts = _systems(name)
    x0 = np.asarray(x0)
    ref = JS.solve_gauss_newton(js, jnp.asarray(x0), *cfg)
    out = TS.solve_gauss_newton(ts, torch.as_tensor(x0)[None], *cfg)
    _check(out, 0, ref)
    if case == "factorization_failure":
        assert not bool(out.converged[0])
        assert float((out.x[0] - torch.as_tensor(x0)).abs().max()) == 0.0
    elif case == "solves_nonlinear":
        assert bool(out.converged[0])
        np.testing.assert_allclose(out.x[0].numpy(), [0.0, 0.0, 3.0, 4.0], atol=1e-7)
    elif case == "step_tolerance_inclusive":
        assert bool(out.converged[0]) and int(out.iterations[0]) == 0
        assert float(out.x[0, 0]) == 3.0
    else:  # one damped step from x0, unconverged
        assert not bool(out.converged[0])
        _r, jtj, jtr, _d = ts.normal_equations(torch.as_tensor(x0)[None])
        d, _fail = TS.damped_spd_solve(jtj, torch.tensor([1e-9], dtype=torch.float64), -jtr)
        np.testing.assert_allclose(out.x.numpy(), (torch.as_tensor(x0)[None] + d).numpy(),
                                   rtol=0, atol=1e-14)


def test_gauss_newton_residual_check_is_inclusive():
    """``test_gauss_newton_residual_check_is_inclusive``: rerun with rtol
    equal to the residual the first run reached; the run stops at the same
    trip with the same x (JAX the same)."""
    js, ts = _systems("pinned_distance")
    x0 = np.array([0.1, -0.1, 3.2, 3.6])
    xt = torch.as_tensor(x0)[None]
    g1 = TS.solve_gauss_newton(ts, xt, 35, 1e-8, 1e-12, 1e-9)
    tie = float(g1.residual.abs().max())
    assert tie > 0.0
    g2 = TS.solve_gauss_newton(ts, xt, 35, tie, 1e-12, 1e-9)
    assert bool(g2.converged[0]) and int(g2.iterations[0]) == int(g1.iterations[0])
    assert torch.equal(g2.x, g1.x)
    _check(g2, 0, JS.solve_gauss_newton(js, jnp.asarray(x0), 35, tie, 1e-12, 1e-9))


def test_gauss_newton_lanes_match_jax_alone():
    """One batch of the under-constrained lone distance mixing lanes that
    converge, lanes whose factorization fails at lambda 0, lanes that
    start degenerate (p = q: a zero Jacobian, a zero step) and lanes that
    run out of budget: every lane as JAX's solve of that lane alone.

    JAX runs op by op (``jax.disable_jit``): at lambda 0 the rank-1 JtJ is
    singular only up to rounding, so whether a factorization fails, and
    where the steps go, follows the last bits; jitted, XLA's fused
    arithmetic rounds otherwise (one lane here ends 5.5 away, both runs
    unconverged), while op by op JAX takes the port's operations."""
    js, ts = _systems("lone_distance")
    rng = np.random.default_rng(4)
    x0s = np.concatenate([rng.uniform(-3.0, 3.0, (4, 4)),
                          [[0.0, 0.0, 0.0, 0.0], [1.0, 0.0, 1.0, 0.0]]])
    for lam, budget in ((1e-3, 35), (0.0, 6), (1e-3, 2)):
        out = TS.solve_gauss_newton(ts, torch.as_tensor(x0s), budget, 1e-8, 1e-12, lam)
        with jax.disable_jit():
            for k in range(len(x0s)):
                _check(out, k, JS.solve_gauss_newton(js, jnp.asarray(x0s[k]), budget,
                                                     1e-8, 1e-12, lam))


def test_gauss_newton_coupled_chain_matches_jax():
    """The 200-line ``coupled`` chain (800 variables: the library
    Cholesky above 24 variables), two seeded copies: converged in as many
    iterations as JAX, x within 1e-10."""
    js, ts, x0 = _coupled(200)
    x0s = x0 + np.random.default_rng(9).normal(0.0, 1e-3, (2, len(x0)))
    cfg = (35, 1e-8, 1e-12, 1e-9)
    out = TS.solve_gauss_newton(ts, torch.as_tensor(x0s), *cfg)
    run = jax.jit(lambda x: JS.solve_gauss_newton(js, x, *cfg))
    for k in range(2):
        ref = run(jnp.asarray(x0s[k]))
        assert bool(ref.converged)
        _check(out, k, ref)
