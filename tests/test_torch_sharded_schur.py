"""The port's ``ShardedSchurSolver`` over gloo ranks on the CPU against the
JAX package's over faked CPU devices (``tests/conftest.py``), on the cases
of ``tests/test_parallel.py`` (the sharded ones) and the CG boundary.

The system is ``test_parallel._coupled_chain_problem``: 8 chains of 4
points (pinned, unit distances, horizontal), neighbouring chains coupled by
a ``ScalarEqual`` across the partition cut. The port runs on 8 gloo ranks
where the JAX test uses the 8-device mesh, and on 4 where it uses 4, all
of this file's port cases in ONE ``dist.run_ranks`` call (a module
fixture: the ranks' spawn is paid once).

What must hold, and why:

* converged, satisfied and degenerate flags, iterations and the boundary
  size equal to JAX's: the same layout (numpy code copied) and the same
  algebra;
* x within 1e-6 of JAX's where both converged (``test_parallel.py``'s own
  tolerance; the chains are short, so the sums' other order moves x by
  round-off only);
* every rank returns rank 0's outcome (a hash gathered from every rank);
* the singular interior (``test_parallel.py:207``): finite x and at most 8
  iterations on both sides;
* the collectives: one packed sum per reduction, as JAX's ``psum``s (the
  max|r| and max|step| ride in one-hot slots): dense, 2 + 2 per LM trip
  (the start, the Schur matrix with its rhs, the trial evaluation, the
  closing gather; 2 + 1 per trip with no boundary); CG, 2 + 3 per trip
  and one per CG trip (the rhs, the matvec of the zero start, the trial
  evaluation).
"""

import doctest

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from ezpz_tpu.config import Config as JConfig
from ezpz_tpu.constraints import Constraint as JConstraint
from ezpz_tpu.datatypes import DatumLineSegment as JSegment
from ezpz_tpu.datatypes import DatumPoint as JPoint
from ezpz_tpu.parallel import ShardedSchurSolver as JSolver
from ezpz_tpu_torch import dryrun
from ezpz_tpu_torch.config import Config as TConfig
from ezpz_tpu_torch.constraints import Constraint as TConstraint
from ezpz_tpu_torch.datatypes import DatumLineSegment as TSegment
from ezpz_tpu_torch.datatypes import DatumPoint as TPoint
from ezpz_tpu_torch.parallel import ShardedSchurSolver as TSolver
from ezpz_tpu_torch.parallel import dist, schur

X_TOL = 1e-6
SINGULAR_CFG = dict(initial_lambda=0.0, max_iterations=8)


def _coupled_chain(C, Point, Segment, n_blocks=8, pts_per_block=4, drop_horizontal=False):
    """``test_parallel._coupled_chain_problem`` in either package;
    ``drop_horizontal`` orphans one point's rotation (the singular case)."""
    constraints = []
    n_vars = n_blocks * pts_per_block * 2
    x0 = np.zeros(n_vars)
    rng = np.random.default_rng(0)
    for b in range(n_blocks):
        base = b * pts_per_block * 2
        pts = [Point(base + 2 * i, base + 2 * i + 1) for i in range(pts_per_block)]
        constraints.append(C.Fixed(pts[0].x_id, float(b)))
        constraints.append(C.Fixed(pts[0].y_id, 0.0))
        for i in range(pts_per_block - 1):
            constraints.append(C.Distance(pts[i], pts[i + 1], 1.0))
            constraints.append(C.Horizontal(Segment(pts[i], pts[i + 1])))
        x0[base: base + 2 * pts_per_block: 2] = float(b) + np.arange(pts_per_block) * 1.1
        x0[base + 1: base + 2 * pts_per_block: 2] = rng.uniform(-0.3, 0.3, pts_per_block)
    for b in range(n_blocks - 1):
        last_y = b * pts_per_block * 2 + (pts_per_block - 1) * 2 + 1
        next_first_y = (b + 1) * pts_per_block * 2 + 1
        constraints.append(C.ScalarEqual(last_y, next_first_y))
    if drop_horizontal:
        first = next(i for i, c in enumerate(constraints) if c.kind == C.HORIZONTAL)
        constraints = constraints[:first] + constraints[first + 1:]
    return constraints, x0


def _problem(side, variant):
    C, Point, Segment = ((JConstraint, JPoint, JSegment) if side == "jax"
                         else (TConstraint, TPoint, TSegment))
    cs, x0 = _coupled_chain(C, Point, Segment, drop_horizontal=variant == "singular")
    if variant == "no_coupling":
        cs = [c for c in cs if c.kind != C.SCALAR_EQUAL]
    return cs, x0


# name -> (variant, ranks, constructor options, config options)
CASES = {
    "dense_f64": ("chain", 8, dict(), {}),
    "dense_f64_4": ("chain", 4, dict(), {}),
    "dense_mixed_4": ("chain", 4, dict(precision="mixed"), {}),
    "cg_f64": ("chain", 8, dict(boundary_solver="cg"), {}),
    "cg_mixed": ("chain", 8, dict(boundary_solver="cg", precision="mixed"), {}),
    "auto_f64": ("chain", 8, dict(boundary_solver="auto"), {}),
    "no_coupling": ("no_coupling", 8, dict(), {}),
    "singular": ("singular", 8, dict(), SINGULAR_CFG),
}


@pytest.fixture(scope="module")
def port():
    """Every case on 8 gloo ranks (4-rank cases on a group of the first
    4), one spawn for the module: name -> rank 0's report."""
    cases = []
    for variant, ranks, opts, cfg in CASES.values():
        cs, x0 = _problem("torch", variant)
        cases.append(dict(solver="schur", constraints=cs, n_vars=len(x0),
                          kwargs=dict(opts, config=TConfig(**cfg)),
                          ranks=None if ranks == 8 else ranks, steps=[("solve", (x0,))]))
    reports = dist.run_ranks(dryrun.run_cases, 8, "gloo", ["cpu"] * 8, cases)
    return {name: rep[0] for name, rep in zip(CASES, reports)}


@pytest.fixture(scope="module")
def jax_out():
    """The JAX solver on the same cases, each on its mesh (the same
    compiled solver serves every case of one shape)."""
    out = {}
    for name, (variant, ranks, opts, cfg) in CASES.items():
        cs, x0 = _problem("jax", variant)
        mesh = Mesh(np.array(jax.devices()[:ranks]), ("d",))
        out[name] = JSolver(cs, len(x0), mesh=mesh, config=JConfig(**cfg), **opts).solve(x0)
    return out


@pytest.mark.parametrize("name", [n for n in CASES if n != "singular"])
def test_matches_jax(port, jax_out, name):
    rep, ref = port[name], jax_out[name]
    out = rep["out"]
    assert rep["agree"], "a rank's outcome differs from rank 0's"
    for key in ("converged", "iterations", "n_boundary", "n_interior"):
        assert out[key] == ref[key], (key, out[key], ref[key])
    np.testing.assert_array_equal(out["satisfied"], ref["satisfied"])
    np.testing.assert_array_equal(out["degenerate"], ref["degenerate"])
    assert out["converged"] and out["satisfied"].all()
    np.testing.assert_allclose(out["x"], ref["x"], rtol=0, atol=X_TOL)


def test_genuine_coupling_and_none(port):
    """The chain has a boundary over 8 ranks; without the couplers it has
    none (``test_parallel.py``'s no-coupling case)."""
    assert port["dense_f64"]["out"]["n_boundary"] > 0
    assert port["no_coupling"]["out"]["n_boundary"] == 0


def test_mixed_matches_f64(port):
    """``precision="mixed"`` reaches the same solution as f64 on the same
    4 ranks (``test_sharded_schur_mixed_precision``)."""
    np.testing.assert_allclose(port["dense_mixed_4"]["out"]["x"],
                               port["dense_f64_4"]["out"]["x"], atol=X_TOL)


def test_singular_interior_terminates(port, jax_out):
    """initial_lambda = 0 on a rank-deficient interior: finite outputs and
    at most 8 iterations, on both sides, and every rank agrees."""
    rep, ref = port["singular"], jax_out["singular"]
    for out in (rep["out"], ref):
        assert np.isfinite(np.asarray(out["x"])).all()
        assert int(out["iterations"]) <= 8
    assert rep["agree"]
    assert rep["out"]["converged"] == ref["converged"]


@pytest.mark.parametrize("name", ["dense_f64", "dense_mixed_4", "no_coupling"])
def test_one_packed_collective_per_reduction_dense(port, name):
    counts = port[name]["counts"]
    per_trip = 2 if port[name]["out"]["n_boundary"] else 1  # no boundary: no Schur sum
    assert counts["collectives"] == 2 + per_trip * counts["lm_trips"], counts
    assert counts["cg_trips"] == 0
    # One host sync per loop check and one for the result.
    assert counts["host_syncs"] <= counts["lm_trips"] + 2


@pytest.mark.parametrize("name", ["cg_f64", "cg_mixed"])
def test_one_packed_collective_per_reduction_cg(port, name):
    counts = port[name]["counts"]
    assert counts["cg_trips"] > 0
    assert counts["collectives"] == 2 + 3 * counts["lm_trips"] + counts["cg_trips"], counts


def test_auto_resolves_to_dense_for_a_small_boundary():
    cs, x0 = _problem("torch", "chain")
    assert TSolver(cs, len(x0), boundary_solver="auto", device="cpu").boundary_solver == "dense"
    assert schur.resolve_boundary_solver("auto", 300, 0, banded_ok=False) == "cg"
    assert schur.resolve_boundary_solver("auto", 300, 11, banded_ok=False) == "cg"
    assert schur.resolve_boundary_solver("auto", 300, 11) == "banded"


def test_world_of_one_equals_jax_one_device():
    """With no process group the solver is a world of one on its device,
    as under JAX's 1-device mesh: the whole system one interior."""
    tcs, x0 = _problem("torch", "chain")
    jcs, _ = _problem("jax", "chain")
    out = TSolver(tcs, len(x0), device="cpu").solve(x0)
    ref = JSolver(jcs, len(x0), mesh=Mesh(np.array(jax.devices()[:1]), ("d",))).solve(x0)
    assert out["n_boundary"] == ref["n_boundary"] == 0
    assert out["iterations"] == ref["iterations"] and out["converged"] == ref["converged"]
    np.testing.assert_allclose(out["x"], ref["x"], rtol=0, atol=X_TOL)


def test_docstring_example():
    failures, tried = doctest.testmod(schur, verbose=False)
    assert tried > 0 and failures == 0


def test_comm_world_of_one():
    """No group: every collective is the identity, counted; ``onehot``
    puts the value in slot 0."""
    import torch

    comm = dist.Comm("cpu")
    assert (comm.rank, comm.size, comm.distributed) == (0, 1, False)
    t = torch.tensor([1.0, 2.0], dtype=torch.float64)
    assert comm.psum(t) is t and t.tolist() == [1.0, 2.0]
    assert comm.onehot(torch.tensor(3.0)).tolist() == [3.0]
    assert comm.gather(t).shape == (1, 2)
    assert (comm.collectives, comm.bytes) == (2, 32)


def test_nccl_needs_one_card_per_rank():
    """NCCL refuses two ranks on one GPU: ``run_ranks`` says so before any
    rank starts, and refuses NCCL on the CPU."""
    with pytest.raises(ValueError, match="one rank per GPU"):
        dist.run_ranks(dryrun.run_cases, 2, "nccl", ["cuda:0", "cuda:0"], [])
    with pytest.raises(ValueError, match="gloo"):
        dist.run_ranks(dryrun.run_cases, 2, "nccl", ["cpu", "cpu"], [])


def test_a_failing_rank_fails_the_call():
    """A rank that raises fails ``run_ranks`` with that rank's traceback."""
    import torch.multiprocessing as tmp

    bad = dict(solver="schur", constraints=[], n_vars=0, kwargs=dict(precision="f16"))
    with pytest.raises(tmp.ProcessRaisedException, match="precision must be"):
        dist.run_ranks(dryrun.run_cases, 2, "gloo", ["cpu"] * 2, [bad])
