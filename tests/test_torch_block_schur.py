"""The port's ``BlockSchurSolver`` against the JAX package's, on the CPU.

The system is the ``coupled`` chain of ``tools/gen_massive.py`` (vertical
lines whose lengths are chained by ``lines_equal_length``: fully
constrained, not block-diagonal) at 80 lines and 16 parts, which gives each
part the operating point's shape (``bench.py``: 600 lines, 120 parts):
interiors of m = 16 variables (the unrolled Crout), local boundaries of
kb = 12 and a half-bandwidth of 11. Guesses are the fixture's moved by
seeded N(0, 1e-3).

What must hold, and why:

* the static structure (parts, boundary, the gather and band maps, the
  resolved boundary solver, ``"auto"`` included) equals JAX's exactly:
  both are the same numpy code;
* one ``_schur_step`` at the guesses in f64 within 1e-12 of JAX's,
  relative to the step's largest entry, for the dense, banded and CG
  boundaries: the same algebra, summed in another order by the
  contractions;
* ``solve_batch`` and ``solve`` for dense, banded, CG and auto, in f64 and
  mixed: converged, satisfied and degenerate flags equal; iterations equal
  in f64 and within 1 in mixed (f32 rounding of the Jacobian pass may move
  an accept); x within 1e-9 (f64) and 1e-6 (mixed), the chain being fully
  constrained;
* the docstring example, a block-diagonal system (no boundary) and a
  weight-0 degenerate constraint (``tests/test_block_schur.py``) answer
  as JAX's solver does: flags and iterations equal, x within 1e-6 (these
  sketches are not fully constrained).

Each JAX solver is compiled once, for the module (5-15 s each on a
desktop-class CPU); ``"auto"`` reuses the result of the boundary it
resolves to.
"""

import doctest
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ezpz_tpu.constraints import Constraint as JConstraint
from ezpz_tpu.datatypes import DatumPoint as JPoint
from ezpz_tpu.parallel import BlockSchurSolver as JSolver
from ezpz_tpu.textual import Problem as JProblem
from ezpz_tpu_torch.benches.coupled_bench import build_problem, generate_coupled
from ezpz_tpu_torch.constraints import Constraint as TConstraint
from ezpz_tpu_torch.datatypes import DatumPoint as TPoint
from ezpz_tpu_torch.parallel import BlockSchurSolver as TSolver
from ezpz_tpu_torch.parallel import block_schur

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINES, PARTS, LANES = 80, 16, 3
STRUCTURE = ("P", "m", "kb", "n_b", "band_bw", "boundary", "boundary_solver")
MAPS = ("l2g", "bmap", "int_map", "band_rows", "band_off", "imask")


def _jax_problem(lines):
    cs = JProblem.from_str(generate_coupled(lines)).to_constraint_system()
    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val
    return [r.constraint for r in cs.constraints], x0


@pytest.fixture(scope="module")
def chain():
    """(JAX constraints, port constraints, x0, perturbed guesses (LANES, n))."""
    jc, x0 = _jax_problem(LINES)
    tc, tx0 = build_problem(LINES)
    np.testing.assert_array_equal(x0, tx0)
    x0s = x0 + np.random.default_rng(0).normal(0.0, 1e-3, (LANES, len(x0)))
    return jc, tc, x0, x0s


@pytest.fixture(scope="module")
def jax_results(chain):
    """JAX ``solve_batch`` results by (boundary, precision), computed at
    first use: one compile each."""
    jc, _tc, x0, x0s = chain
    cache = {}

    def get(boundary, precision):
        if (boundary, precision) not in cache:
            s = JSolver(jc, len(x0), n_parts=PARTS, boundary_solver=boundary,
                        precision=precision)
            res, sat = s.solve_batch(x0s)
            cache[boundary, precision] = (
                np.asarray(res.x), np.asarray(res.iterations),
                np.asarray(res.converged), np.asarray(res.deg), np.asarray(sat))
        return cache[boundary, precision]

    return get


def test_generator_is_the_tools_fixture():
    """The port's copy of ``generate_coupled`` writes what
    ``tools/gen_massive.py N coupled`` writes."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "gen_massive.py"),
                          "7", "coupled"], capture_output=True, text=True, check=True)
    assert out.stdout == generate_coupled(7)


@pytest.mark.parametrize("lines,parts,boundary", [
    (LINES, PARTS, "dense"), (LINES, PARTS, "banded"), (LINES, PARTS, "cg"),
    (LINES, PARTS, "auto"), (LINES, 8, "auto"), (40, 4, "auto"),
    (600, 120, "banded"), (600, 40, "auto")])
def test_structure_matches_jax(lines, parts, boundary):
    jc, x0 = _jax_problem(lines)
    tc, _ = build_problem(lines)
    for precision in ("f64", "mixed"):
        j = JSolver(jc, len(x0), n_parts=parts, boundary_solver=boundary,
                    precision=precision)
        t = TSolver(tc, len(x0), n_parts=parts, boundary_solver=boundary,
                    precision=precision, device="cpu")
        for name in STRUCTURE:
            assert getattr(t, name) == getattr(j, name), name
        for name in MAPS:
            np.testing.assert_array_equal(getattr(t, name), np.asarray(getattr(j, name)),
                                          err_msg=name)
        assert t.jac_dtype == (torch.float32 if precision == "mixed" else torch.float64)
    if (lines, parts) == (600, 120):
        assert (t.P, t.m, t.kb, t.n_b, t.band_bw) == (120, 16, 12, 952, 11)


@pytest.mark.parametrize("boundary", ["dense", "banded", "cg"])
def test_schur_step_matches_jax(chain, boundary):
    jc, tc, x0, x0s = chain
    lam = 1e-3
    j = JSolver(jc, len(x0), n_parts=PARTS, boundary_solver=boundary, precision="f64")
    t = TSolver(tc, len(x0), n_parts=PARTS, boundary_solver=boundary, precision="f64",
                device="cpu")
    jd, jfail, jdeg = jax.jit(j._schur_step)(jnp.asarray(x0s[0]), jnp.asarray(lam))
    td, tfail, tdeg = t._schur_step(torch.as_tensor(x0s[:1]),
                                    torch.tensor([lam], dtype=torch.float64))
    assert not bool(jfail) and not bool(tfail[0])
    np.testing.assert_array_equal(tdeg[0].numpy(), np.asarray(jdeg))
    jd = np.asarray(jd)
    np.testing.assert_allclose(td[0].numpy(), jd, rtol=0, atol=1e-12 * np.abs(jd).max())


@pytest.mark.parametrize("precision", ["f64", "mixed"])
@pytest.mark.parametrize("boundary", ["dense", "banded", "cg", "auto"])
def test_solves_match_jax(chain, jax_results, boundary, precision):
    jc, tc, x0, x0s = chain
    t = TSolver(tc, len(x0), n_parts=PARTS, boundary_solver=boundary,
                precision=precision, device="cpu")
    resolved = JSolver(jc, len(x0), n_parts=PARTS, boundary_solver=boundary).boundary_solver
    assert t.boundary_solver == resolved
    jx, jits, jconv, jdeg, jsat = jax_results(resolved, precision)
    res, sat = t.solve_batch(x0s)
    assert res.x.dtype == torch.float64 and res.x.shape == (LANES, len(x0))
    np.testing.assert_array_equal(res.converged.numpy(), jconv)
    np.testing.assert_array_equal(sat.numpy(), jsat)
    np.testing.assert_array_equal(res.deg.numpy(), jdeg)
    assert jconv.all() and jsat.all()
    if precision == "f64":
        np.testing.assert_array_equal(res.iterations.numpy(), jits)
    else:
        assert (np.abs(res.iterations.numpy() - jits) <= 1).all()
    tol = 1e-9 if precision == "f64" else 1e-6
    np.testing.assert_allclose(res.x.numpy(), jx, rtol=0, atol=tol)
    # ``solve`` is one lane of ``solve_batch``.
    one = t.solve(x0s[0])
    np.testing.assert_array_equal(one["x"], res.x[0].numpy())
    assert one["iterations"] == int(res.iterations[0])
    assert one["converged"] is True and one["satisfied"].all()
    assert (one["n_boundary"], one["n_interior"], one["n_parts"]) == (t.n_b, t.m, t.P)


def _pair(pkg_constraint, pkg_point):
    """The JAX docstring's two distance sketches coupled across the cut."""
    C, Pt = pkg_constraint, pkg_point
    p, q, r, s = Pt(0, 1), Pt(2, 3), Pt(4, 5), Pt(6, 7)
    return [C.Fixed(0, 0.0), C.Fixed(1, 0.0), C.Distance(p, q, 2.0),
            C.Fixed(4, 1.0), C.Fixed(5, 0.0), C.Distance(r, s, 2.0),
            C.ScalarEqual(3, 7)]


def _uncoupled(pkg_constraint, pkg_point):
    cs = []
    for b in range(2):
        p, q = pkg_point(4 * b, 4 * b + 1), pkg_point(4 * b + 2, 4 * b + 3)
        cs += [pkg_constraint.Fixed(p.x_id, 0.0), pkg_constraint.Fixed(p.y_id, 0.0),
               pkg_constraint.Distance(p, q, 5.0)]
    return cs


SMALL = {
    # name: (constraints of a package, x0, weights, n_parts, precision)
    "docstring": (_pair, [0.0, 0.0, 1.4, 1.5, 1.0, 0.0, 2.4, 1.6], None, 2, "f64"),
    "no_boundary": (_uncoupled, [0.0, 0.0, 3.0, 3.0, 0.0, 0.0, 4.0, 3.0], None, 2, "f64"),
    "weight_zero": (_pair, [0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 2.4, 1.6],
                    [1.0, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0], 2, "f64"),
}


@pytest.mark.parametrize("case", list(SMALL))
def test_small_systems_match_jax(case):
    build, x0, weights, parts, precision = SMALL[case]
    x0 = np.asarray(x0)
    j = JSolver(build(JConstraint, JPoint), 8, n_parts=parts, weights=weights,
                precision=precision).solve(x0)
    t = TSolver(build(TConstraint, TPoint), 8, n_parts=parts, weights=weights,
                precision=precision, device="cpu").solve(x0)
    for key in ("iterations", "converged", "n_boundary", "n_interior", "n_parts"):
        assert t[key] == j[key], key
    np.testing.assert_array_equal(t["satisfied"], np.asarray(j["satisfied"]))
    np.testing.assert_array_equal(t["degenerate"], np.asarray(j["degenerate"]))
    # These sketches leave points free on circles, so the two packages'
    # rounding may settle on least-squares points a few 1e-9 apart.
    np.testing.assert_allclose(t["x"], np.asarray(j["x"]), rtol=0, atol=1e-6)
    if case == "no_boundary":
        assert t["n_boundary"] == 0
    if case == "weight_zero":
        assert np.flatnonzero(t["degenerate"]).tolist() == [2]


def test_weight_zero_degeneracy_mixed_flags():
    """In mixed precision the weight-0 case's free point follows f32
    rounding (the port's trip count differs from JAX's on this
    under-constrained sketch), so, as ``tests/test_block_schur.py`` does,
    only the flags are held: the degenerate constraint and no other."""
    build, x0, weights, parts, _precision = SMALL["weight_zero"]
    j = JSolver(build(JConstraint, JPoint), 8, n_parts=parts, weights=weights,
                precision="mixed").solve(np.asarray(x0))
    t = TSolver(build(TConstraint, TPoint), 8, n_parts=parts, weights=weights,
                precision="mixed", device="cpu").solve(np.asarray(x0))
    np.testing.assert_array_equal(t["degenerate"], np.asarray(j["degenerate"]))
    np.testing.assert_array_equal(t["satisfied"], np.asarray(j["satisfied"]))
    assert t["converged"] == j["converged"]
    assert np.flatnonzero(t["degenerate"]).tolist() == [2]


def test_docstring_example_runs():
    failures, tried = doctest.testmod(block_schur, verbose=False)
    assert tried > 0 and failures == 0


def test_default_device_is_the_card(chain):
    """Without ``device`` the solver wants the GPU, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _jc, tc, x0, _x0s = chain
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSolver(tc, len(x0), n_parts=PARTS)


def test_rejects_unknown_options(chain):
    _jc, tc, x0, _x0s = chain
    with pytest.raises(ValueError, match="precision"):
        TSolver(tc, len(x0), precision="f16", device="cpu")
    with pytest.raises(ValueError, match="boundary_solver"):
        TSolver(tc, len(x0), boundary_solver="lu", device="cpu")
