"""The port's ``ShardedBlockSchurSolver`` over 8 gloo ranks on the CPU
against the JAX package's over the 8 faked CPU devices, on the cases of
``tests/test_hier_schur.py`` and on every boundary in both precisions.

Systems: the ``coupled`` chain of ``tools/gen_massive.py`` (vertical lines
whose lengths are chained by ``lines_equal_length``: fully constrained, not
block-diagonal) at 24 lines and 8 parts (one part per rank, the chain's
half-bandwidth 11) and at 60 lines with the default parts; the hub
assembly (``generate_coupled_hub(51, 5)``) with its cluster partition; and
``test_hier_schur.py``'s degenerate sketch. All of this file's port cases
run in ONE ``dist.run_ranks`` call (a module fixture).

What must hold, and why:

* the structure (parts, boundary size, the local boundary width, the
  half-bandwidth, the resolved boundary solver, ``"auto"`` included) equal
  to JAX's: the same numpy layout;
* converged, satisfied and degenerate flags and iterations equal to JAX's;
  residual_inf <= 1e-8 where converged: the same algebra, each boundary
  solver's (dense and banded exact; CG to 1e-5 relative in f32, 1e-12 in
  f64 on both sides);
* x within 1e-6 of JAX's where both converged (the JAX tests' own
  tolerance): the chains here are at most 59 links long, so one residual
  tolerance per link (the ``COUPLED_X_TOL`` argument of the longer chains
  of ``test_torch_block_schur.py``) stays below it;
* every rank returns rank 0's outcome;
* the collectives: per LM trip one sum for the step, one for the trial
  residual and one for the boundary (the dense S or the band, each with
  the rhs; for CG the rhs with diag(S), and one more per CG trip), plus
  one at the start and one max at the end.
"""

import doctest
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from ezpz_tpu.constraints import Constraint as JConstraint
from ezpz_tpu.datatypes import DatumPoint as JPoint
from ezpz_tpu.parallel import ShardedBlockSchurSolver as JSolver
from ezpz_tpu.textual import Problem as JProblem
from ezpz_tpu_torch import dryrun
from ezpz_tpu_torch.benches.coupled_bench import build_problem, generate_coupled
from ezpz_tpu_torch.constraints import Constraint as TConstraint
from ezpz_tpu_torch.datatypes import DatumPoint as TPoint
from ezpz_tpu_torch.fixtures import coupled_hub, generate_coupled_hub
from ezpz_tpu_torch.parallel import ShardedBlockSchurSolver as TSolver
from ezpz_tpu_torch.parallel import dist, hier

ROOT = Path(__file__).resolve().parents[1]
X_TOL = 1e-6
STRUCTURE = ("P", "n_b", "m", "kb", "band_bw", "boundary_solver")


def _jax_constraints(text):
    cs = JProblem.from_str(text).to_constraint_system()
    return [r.constraint for r in cs.constraints]


def _degenerate(C, Point):
    p0, p1, p2, p3 = (Point(2 * i, 2 * i + 1) for i in range(4))
    cs = [C.Fixed(0, 0.0), C.Fixed(1, 0.0), C.Distance(p0, p1, 2.0),
          C.Fixed(4, 1.0), C.Fixed(5, 0.0), C.Distance(p2, p3, 2.0),
          C.ScalarEqual(3, 7)]
    return cs, np.array([0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 2.4, 1.6])  # p1 == p0


def _systems():
    """name -> (port constraints, jax constraints, x0, extra options)."""
    out = {}
    for lines in (24, 60):
        cs, x0 = build_problem(lines)
        out[f"chain{lines}"] = (cs, _jax_constraints(generate_coupled(lines)), x0, {})
    cs, x0, pov = coupled_hub(51, 5)
    out["hub"] = (cs, _jax_constraints(generate_coupled_hub(51, 5)), x0,
                  dict(part_of_var=pov))
    tcs, x0 = _degenerate(TConstraint, TPoint)
    jcs, _ = _degenerate(JConstraint, JPoint)
    out["degenerate"] = (tcs, jcs, x0, dict(n_parts=2))
    return out


# name -> (system, options); "auto" runs on both sides but reuses JAX's
# result of the boundary it resolves to where that case exists.
CASES = {f"chain24_{b}_{p}": ("chain24", dict(n_parts=8, boundary_solver=b, precision=p))
         for p in ("f64", "mixed") for b in ("dense", "cg", "banded", "auto")}
CASES.update({
    "chain60_dense": ("chain60", dict(boundary_solver="dense")),
    "chain60_cg": ("chain60", dict(boundary_solver="cg")),
    "hub_cg": ("hub", dict(boundary_solver="cg")),
    "hub_auto": ("hub", dict(boundary_solver="auto")),
    "degenerate": ("degenerate", dict()),
})


def _jax_twin(name):
    system, opts = CASES[name]
    if opts.get("boundary_solver") == "auto" and system == "chain24":
        return name.replace("auto", "banded")
    return name


@pytest.fixture(scope="module")
def systems():
    return _systems()


@pytest.fixture(scope="module")
def port(systems):
    cases = []
    for system, opts in CASES.values():
        cs, _jcs, x0, extra = systems[system]
        cases.append(dict(solver="hier", constraints=cs, n_vars=len(x0),
                          kwargs=dict(opts, **extra), steps=[("solve", (x0,))]))
    reports = dist.run_ranks(dryrun.run_cases, 8, "gloo", ["cpu"] * 8, cases)
    return {name: rep[0] for name, rep in zip(CASES, reports)}


@pytest.fixture(scope="module")
def jax_side(systems):
    """name -> (JAX solver, its outcome); an ``auto`` chain case reuses
    the banded case's outcome (the same computation)."""
    mesh = Mesh(np.array(jax.devices()[:8]), ("d",))
    out = {}
    for name, (system, opts) in CASES.items():
        _cs, jcs, x0, extra = systems[system]
        solver = JSolver(jcs, len(x0), mesh=mesh, **opts, **extra)
        twin = _jax_twin(name)
        if twin != name and twin in out:
            out[name] = (solver, out[twin][1])
        else:
            out[name] = (solver, solver.solve(x0))
    return out


def _structure(solver):
    return tuple(getattr(solver, k) for k in STRUCTURE)


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(port, jax_side, name):
    rep = port[name]
    out = rep["out"]
    _jsolver, ref = jax_side[name]
    assert rep["agree"], "a rank's outcome differs from rank 0's"
    for key in ("converged", "iterations", "n_boundary", "n_interior", "n_parts",
                "n_devices"):
        assert out[key] == ref[key], (key, out[key], ref[key])
    np.testing.assert_array_equal(out["satisfied"], ref["satisfied"])
    np.testing.assert_array_equal(out["degenerate"], ref["degenerate"])
    if out["converged"]:
        assert out["residual_inf"] <= 1e-8
        np.testing.assert_allclose(out["x"], ref["x"], rtol=0, atol=X_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_structure_matches_jax(systems, jax_side, name):
    """The layout and the resolved boundary solver, ``auto`` included,
    equal JAX's over 8 devices, built here as a world of one with the
    same parts (the default part count depends on the rank count, and the
    per-rank padding Pl does; nothing else does)."""
    system, opts = CASES[name]
    cs, _jcs, x0, extra = systems[system]
    jsolver, _ref = jax_side[name]
    if not {"n_parts", "part_of_var"} & (set(opts) | set(extra)):
        opts = dict(opts, n_parts=jsolver.P)
    solver = TSolver(cs, len(x0), device="cpu", **opts, **extra)
    assert _structure(solver) == _structure(jsolver)
    for key in ("l2g", "bmap", "int_map", "imask"):
        np.testing.assert_array_equal(
            getattr(solver, key).reshape(-1, getattr(solver, key).shape[-1])[:solver.P],
            getattr(jsolver, key).reshape(-1, getattr(jsolver, key).shape[-1])[:jsolver.P])


def test_expected_structures(jax_side, port):
    """What the JAX tests pin: the chain's band is thin (auto: banded),
    the hub's boundary is the hub line plus one line per cluster and too
    wide a band for banded (auto: dense at this size), the degenerate
    sketch's distance flags."""
    chain = jax_side["chain24_banded_mixed"][0]
    assert 0 < chain.band_bw < chain.n_b
    assert jax_side["chain24_auto_mixed"][0].boundary_solver == "banded"
    assert port["hub_cg"]["out"]["n_boundary"] == 4 + 4 * 10
    assert jax_side["hub_auto"][0].boundary_solver == "dense"
    assert bool(port["degenerate"]["out"]["degenerate"][2])
    for name in ("chain60_cg", "hub_cg"):
        assert port[name]["out"]["converged"] and port[name]["out"]["satisfied"].all()


@pytest.mark.parametrize("name", [n for n in CASES if n != "degenerate"])
def test_collectives_per_reduction(port, name):
    rep = port[name]
    counts, trips = rep["counts"], rep["counts"]["lm_trips"]
    boundary = CASES[name][1].get("boundary_solver", "cg")
    if boundary == "auto":
        boundary = "banded" if name.startswith("chain") else "dense"
    expected = 2 + 3 * trips + counts["cg_trips"]
    assert counts["collectives"] == expected, (counts, expected)
    assert (counts["cg_trips"] > 0) == (boundary == "cg")


def test_docstring_example():
    failures, tried = doctest.testmod(hier, verbose=False)
    assert tried > 0 and failures == 0


def test_world_of_one_matches_jax_one_device(systems):
    """No group: a world of one on the given device, as under JAX's
    1-device mesh (every part on the one rank)."""
    cs, jcs, x0, _ = systems["chain24"]
    opts = dict(n_parts=8, boundary_solver="banded", precision="mixed")
    out = TSolver(cs, len(x0), device="cpu", **opts).solve(x0)
    ref = JSolver(jcs, len(x0), mesh=Mesh(np.array(jax.devices()[:1]), ("d",)),
                  **opts).solve(x0)
    assert (out["iterations"], out["converged"], out["n_devices"]) == \
        (ref["iterations"], ref["converged"], 1)
    np.testing.assert_allclose(out["x"], ref["x"], rtol=0, atol=X_TOL)


def test_the_hub_fixture_is_the_tools_one():
    """``fixtures.generate_coupled_hub`` is ``tools/gen_massive.py``'s."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        from gen_massive import generate_coupled_hub as reference
    finally:
        sys.path.remove(str(ROOT / "tools"))
    for lines, cluster in ((51, 5), (17, 4), (101, 10)):
        assert generate_coupled_hub(lines, cluster) == reference(lines, cluster)
