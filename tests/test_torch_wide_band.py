"""The coupled solver with a boundary band wider than 32, against JAX.

A partition that moves every 4th part's variables to the part 3 to its
right (``coupled_bench.moved_parts``) widens the boundary's band of the
``coupled`` chain to a half-bandwidth of 35. ``boundary_solver="auto"`` resolves it to the
banded boundary in both packages, whose rule has no cap on the width: so
the port's banded solve must answer at every width that JAX's does. On the
card that is the dynamic-width kernel; here, on the CPU, the plain
version ``banded_spd_reference`` (which the kernels equal bit for bit).

What must hold, and why (as ``tests/test_torch_block_schur.py``): the
resolved solver, n_b and bw equal JAX's (the same numpy planning);
converged, satisfied and degenerate flags equal; iterations equal in f64
and within 1 in mixed (f32 rounding of the Jacobian pass may move an
accept); x within 1e-9 (f64) and 1e-6 (mixed): the chain is fully
constrained. Each JAX solve is compiled once for the module (~16 s each).

Beside it, the plain banded solve alone against JAX's
``ezpz_tpu.ops.banded.banded_spd_solve`` (``plain_matches_jax``) at bw
33, 48 and 64 (the edges of the warp kernel's former capacities 48 and
64, which the dynamic-width kernel took over);
``tests/test_torch_wide_band_general.py`` takes 65 and 100. Seeded diagonally dominant bands of
n = bw + 20 rows and B = 2 lanes, lane 1 with a negative pivot: fail flags
equal, the failed lane zero in both, and x within 1e-12 of the largest
|x| in f64 (JAX sums the diagonal's squares with ``jnp.sum`` and XLA may
contract a multiply-add, so the two round differently in the last bits).
JAX compiles its scan body once per width, unrolled (O(bw^2) operations:
~15 s at bw = 64, ~35 s at bw = 100 on a desktop-class CPU), one lane at a
time (a vmapped body compiles about twice as long).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ezpz_tpu.ops.banded import banded_spd_solve as jax_banded_spd_solve
from ezpz_tpu.parallel import BlockSchurSolver as JSolver
from ezpz_tpu.textual import Problem as JProblem
from ezpz_tpu_torch.benches.banded_points import make_band
from ezpz_tpu_torch.benches.coupled_bench import build_problem, generate_coupled, moved_parts
from ezpz_tpu_torch.ops import banded
from ezpz_tpu_torch.parallel import BlockSchurSolver as TSolver

LINES, PARTS, LANES = 120, 24, 2
# (n_b, bw) of the chain under that map: the fault's operating point
# (600 lines, 120 parts) has the same bw at n_b = 952.
STRUCTURE = (184, 35)


@pytest.fixture(scope="module")
def chain():
    """(JAX constraints, port constraints, part map, guesses (LANES, n))."""
    cs = JProblem.from_str(generate_coupled(LINES)).to_constraint_system()
    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val
    tc, tx0 = build_problem(LINES)
    np.testing.assert_array_equal(x0, tx0)
    x0s = x0 + np.random.default_rng(0).normal(0.0, 1e-3, (LANES, len(x0)))
    return [r.constraint for r in cs.constraints], tc, moved_parts(len(x0), PARTS, 4, 3), x0s


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_wide_band_auto_boundary_matches_jax(chain, precision):
    jc, tc, q, x0s = chain
    n = x0s.shape[1]
    j = JSolver(jc, n, part_of_var=q, boundary_solver="auto", precision=precision)
    t = TSolver(tc, n, part_of_var=q, boundary_solver="auto", precision=precision,
                device="cpu")
    assert (t.n_b, t.band_bw) == (j.n_b, j.band_bw) == STRUCTURE
    assert t.boundary_solver == j.boundary_solver == "banded"
    jres, jsat = j.solve_batch(x0s)
    res, sat = t.solve_batch(x0s)
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(jres.converged))
    np.testing.assert_array_equal(sat.numpy(), np.asarray(jsat))
    np.testing.assert_array_equal(res.deg.numpy(), np.asarray(jres.deg))
    assert bool(res.converged.all()) and bool(sat.all())
    its, jits = res.iterations.numpy(), np.asarray(jres.iterations)
    if precision == "f64":
        np.testing.assert_array_equal(its, jits)
    else:
        assert (np.abs(its - jits) <= 1).all()
    tol = 1e-9 if precision == "f64" else 1e-6
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0, atol=tol)
    assert res.x.dtype == torch.float64


_jax_solve = jax.jit(jax_banded_spd_solve)


def plain_matches_jax(bw):
    """``banded_spd_reference`` against JAX's banded solve at ``bw`` (see
    the module docstring)."""
    n = bw + 20
    Ab, b = make_band(2, n, bw, seed=bw)
    Ab[1, n // 2, bw] = -1.0
    x, fail = banded.banded_spd_reference(Ab, b)
    jx, jfail = zip(*(_jax_solve(jnp.asarray(Ab[k].numpy()), jnp.asarray(b[k].numpy()))
                      for k in range(2)))
    jx = np.stack([np.asarray(v) for v in jx])
    assert fail.tolist() == [bool(f) for f in jfail] == [False, True]
    assert not x[1].any() and not jx[1].any()
    scale = np.abs(jx[0]).max()
    assert scale > 0 and x.dtype == torch.float64
    np.testing.assert_allclose(x[0].numpy(), jx[0], rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("bw", [33, 48, 64])
def test_plain_wide_band_matches_jax(bw):
    plain_matches_jax(bw)
