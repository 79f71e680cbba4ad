"""Checkpoint/resume of the port's ``ShardedSchurSolver`` over 4 gloo ranks
on the CPU: the seven cases of ``tests/test_checkpoint.py``, against the
JAX solver on 4 faked devices where an outcome is compared.

The system is ``fixtures.horizontal_chain`` with the JAX test's spacing
and offsets (12 points, or 10 and 8). All of this file's ranked cases run
in ONE ``dist.run_ranks`` call (a module fixture), in order: a case may
leave a checkpoint file that the next one finds.

What must hold, and why:

* a checkpointed solve (1 iteration per segment) equals the plain solve
  (x within 1e-9: the same arithmetic in segments), leaves no file, and
  re-running it gives the same iterations and x;
* a resume really resumes: the JAX test's by-hand segment is saved under a
  fingerprint of ``cons_map`` and ``local_to_global`` only, which
  ``solve_checkpointed`` (whose fingerprint also covers the values, the
  configuration and x0) never matches, so its "resume" starts fresh. Here
  the segment is saved under ``solver.fingerprint(x0)``, and the resumed
  solve takes one LM trip fewer than a fresh one while reporting the
  plain solve's total iterations and x;
* a stale checkpoint of the same topology with another value, or of
  another topology, or a corrupt file, is ignored: the solve takes as many
  trips as a fresh one and matches the plain solve;
* the port's fingerprint of a solve is the JAX solver's (the same arrays);
* the plain and checkpointed outcomes equal JAX's (flags and iterations;
  x within 1e-6).
"""

import os

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from ezpz_tpu.constraints import Constraint as JConstraint
from ezpz_tpu.datatypes import DatumPoint as JPoint
from ezpz_tpu.fixtures import horizontal_chain as jchain
from ezpz_tpu.parallel import ShardedSchurSolver as JSolver
from ezpz_tpu_torch import dryrun
from ezpz_tpu_torch.checkpoint import load_state, save_state, topology_fingerprint
from ezpz_tpu_torch.constraints import Constraint as TConstraint
from ezpz_tpu_torch.datatypes import DatumPoint as TPoint
from ezpz_tpu_torch.fixtures import horizontal_chain as tchain
from ezpz_tpu_torch.parallel import ShardedSchurSolver as TSolver
from ezpz_tpu_torch.parallel import dist

RANKS = 4
X_TOL = 1e-6
SPACING = dict(x_spacing=1.3, x_offset=0.21, y_offset=0.17)


def _chain(n, side="torch"):
    return (tchain if side == "torch" else jchain)(n, **SPACING)


def _changed(side="torch"):
    """The 10-point chain with one Distance target moved (same topology)."""
    C, Point = (TConstraint, TPoint) if side == "torch" else (JConstraint, JPoint)
    cs, x0 = _chain(10, side)
    cs = list(cs)
    cs[2] = C.Distance(Point(0, 1), Point(2, 3), 2.0)
    return cs, x0


def _case(cs, x0, steps):
    return dict(solver="schur", constraints=cs, n_vars=len(x0), steps=steps)


@pytest.fixture(scope="module")
def ckdir(tmp_path_factory):
    return tmp_path_factory.mktemp("checkpoints")


@pytest.fixture(scope="module")
def paths(ckdir):
    names = ("solve", "partial", "values", "other", "corrupt")
    out = {n: str(ckdir / f"{n}.npz") for n in names}
    with open(out["corrupt"], "wb") as f:
        f.write(b"not an npz at all")
    return out


@pytest.fixture(scope="module")
def port(paths):
    """The ranked cases in order, on 4 gloo ranks: name -> rank 0's step
    reports. The file checks that need the run's end (no file left behind)
    are recorded by the tests from ``paths``."""
    cs12, x12 = _chain(12)
    cs10, x10 = _chain(10)
    cs8, x8 = _chain(8)
    changed, xc = _changed()
    cases = {
        "matches_plain": _case(cs12, x12, [
            ("solve", (x12,)),
            ("fingerprint", (x12,)),
            ("solve_checkpointed", (x12, paths["solve"], 1)),
            ("solve_checkpointed", (x12, paths["solve"], 1))]),
        "resume": _case(cs12, x12, [
            ("solve", (x12,)),
            ("partial_checkpoint", (x12, paths["partial"], 1)),
            ("solve_checkpointed", (x12, paths["partial"], 2))]),
        # A stale file of the same topology: the 10-point chain, preempted.
        "values_stale": _case(cs10, x10, [("partial_checkpoint", (x10, paths["values"], 1))]),
        "values_changed": _case(changed, xc, [
            ("solve", (xc,)),
            ("solve_checkpointed", (xc, paths["values"], 2))]),
        # A stale file of another topology.
        "other_stale": _case(cs10, x10, [("partial_checkpoint", (x10, paths["other"], 1))]),
        "other_topology": _case(cs12, x12, [
            ("solve", (x12,)),
            ("solve_checkpointed", (x12, paths["other"], 3))]),
        "corrupt": _case(cs8, x8, [
            ("solve", (x8,)),
            ("solve_checkpointed", (x8, paths["corrupt"], 4))]),
    }
    reports = dist.run_ranks(dryrun.run_cases, RANKS, "gloo", ["cpu"] * RANKS, list(cases.values()))
    return dict(zip(cases, reports))


@pytest.fixture(scope="module")
def jax_plain():
    """The JAX solver (4 faked devices) and its plain solves of the
    12-point chain and of the changed 10-point chain."""
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("d",))
    cs, x0 = _chain(12, "jax")
    solver = JSolver(cs, len(x0), mesh=mesh)
    changed, xc = _changed("jax")
    return dict(plain=solver.solve(x0), solver=solver,
                changed=JSolver(changed, len(xc), mesh=mesh).solve(xc))


def _same(out, ref, atol):
    assert out["converged"] == ref["converged"] and out["iterations"] == ref["iterations"]
    np.testing.assert_array_equal(out["satisfied"], ref["satisfied"])
    np.testing.assert_allclose(out["x"], ref["x"], rtol=0, atol=atol)


def test_checkpointed_matches_plain(port, paths, jax_plain):
    plain, _fp, ck, again = port["matches_plain"]
    assert ck["out"]["converged"] and ck["out"]["satisfied"].all()
    _same(ck["out"], plain["out"], 1e-9)
    # A finished solve removes its checkpoint; re-running starts fresh.
    assert not os.path.exists(paths["solve"])
    assert again["out"]["iterations"] == ck["out"]["iterations"]
    np.testing.assert_allclose(again["out"]["x"], ck["out"]["x"], atol=0)
    assert again["counts"]["lm_trips"] == ck["counts"]["lm_trips"]
    assert all(step["agree"] for step in (plain, ck, again))
    _same(plain["out"], jax_plain["plain"], X_TOL)
    _same(ck["out"], jax_plain["plain"], X_TOL)


def test_resume_from_partial_checkpoint(port, paths):
    """Preemption after one 1-iteration segment: the segment reports its
    own limit (not max_iterations), and the resumed solve finishes in one
    trip fewer than the plain solve took, with its iterations and x."""
    plain, partial, resumed = port["resume"]
    assert partial["out"]["it"] == 1 and not partial["out"]["finished"]
    assert partial["out"]["iterations"] == 1
    out = resumed["out"]
    assert out["converged"] and out["satisfied"].all()
    _same(out, plain["out"], 1e-9)
    assert plain["counts"]["lm_trips"] >= 2
    assert resumed["counts"]["lm_trips"] == plain["counts"]["lm_trips"] - 1
    assert not os.path.exists(paths["partial"])


def test_changed_values_invalidate_checkpoint(port, jax_plain):
    """Same topology, another parameter: the stale file is ignored, so the
    solve runs every trip from the start."""
    plain, ck = port["values_changed"]
    assert ck["out"]["converged"] and ck["out"]["satisfied"].all()
    _same(ck["out"], plain["out"], 1e-9)
    assert ck["counts"]["lm_trips"] == plain["counts"]["lm_trips"]
    _same(plain["out"], jax_plain["changed"], X_TOL)


def test_checkpoint_every_must_be_positive(tmp_path):
    cs, x0 = _chain(8)
    solver = TSolver(cs, len(x0), device="cpu")
    with pytest.raises(ValueError):
        solver.solve_checkpointed(x0, str(tmp_path / "x.npz"), checkpoint_every=0)


def test_wrong_topology_checkpoint_ignored(port):
    plain, ck = port["other_topology"]
    assert ck["out"]["converged"] and ck["out"]["satisfied"].all()
    _same(ck["out"], plain["out"], 1e-9)
    assert ck["counts"]["lm_trips"] == plain["counts"]["lm_trips"]


def test_corrupt_checkpoint_ignored(port):
    plain, ck = port["corrupt"]
    assert ck["out"]["converged"] and ck["out"]["satisfied"].all()
    _same(ck["out"], plain["out"], 1e-9)


def test_load_state_roundtrip(tmp_path):
    ck = str(tmp_path / "rt.npz")
    fp = topology_fingerprint(np.arange(6).reshape(2, 3))
    x_i = np.random.default_rng(0).normal(size=(2, 5))
    x_b = np.array([1.0, 2.0])
    deg = np.zeros((2, 4), dtype=bool)
    save_state(ck, fp, x_i, x_b, 1e-7, 3, deg)
    got = load_state(ck, fp)
    assert got is not None
    np.testing.assert_array_equal(got[0], x_i)
    np.testing.assert_array_equal(got[1], x_b)
    assert got[2] == 1e-7 and got[3] == 3
    # Wrong fingerprint -> None.
    assert load_state(ck, topology_fingerprint(np.arange(4))) is None


def test_fingerprint_is_the_jax_solvers(port, jax_plain):
    """The same solve has the same key in both packages: the 4-rank layout
    built from the same constraints, values, configuration and x0 (every
    rank computes the same key)."""
    x0 = _chain(12, "jax")[1]
    jsolver = jax_plain["solver"]
    c = jsolver.config
    expected = topology_fingerprint(
        jsolver.cons_map, jsolver.layout.local_to_global,
        *[b.par for b in jsolver.blocks], *[b.weight for b in jsolver.blocks],
        np.asarray([c.max_iterations, c.residual_tolerance, c.step_tolerance,
                    c.initial_lambda], np.float64),
        np.asarray(x0, np.float64))
    step = port["matches_plain"][1]
    assert step["out"] == expected and step["agree"]
