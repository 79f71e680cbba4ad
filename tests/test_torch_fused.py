"""The fused fleet solver's plain version (``fused_fleet_reference``)
against the JAX fused Pallas kernel, run as tests/test_ds_fused.py runs it:
``BatchSolver(..., precision="mixed", pallas_fused=True)`` on the CPU, in
interpret mode.

Topologies: both buckets of ``massive_parallel_system`` (the main path,
3 coarse + 2 refine trips), ``square`` and ``two_rectangles`` (fully
constrained, library-default 4 + 4 trips) and ``parc_coincident`` (an arc
with a point on it: the atan2-free span classification; under-constrained,
so coordinates are not compared). B = 1024 seeded perturbations
(sigma 1e-3) of each fixture's guesses, shared by both packages.

What must hold, and why:

* converged, satisfied and degenerate flags equal lane for lane, on lanes
  without a NaN residual row (the port reports NaN rows unsatisfied, the
  JAX kernel satisfied);
* both packages' answers have f64 residual <= 1e-8 wherever JAX converged;
* coordinates agree to 1e-6 on fully constrained topologies where both
  converged (two least-squares answers of an under-constrained sketch can
  both be right);
* iterations equal, or off by at most 1: the JAX refine phase rounds in
  double-single, the port's in native f64, which can flip an accept at the
  1e-8 boundary.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ezpz_tpu.batch import BatchSolver as JBatchSolver
from ezpz_tpu.config import Config as JConfig
from ezpz_tpu.models import blocks as JB
from ezpz_tpu_torch.batch import BatchSolver as TBatchSolver
from ezpz_tpu_torch.config import Config as TConfig
from ezpz_tpu_torch.models import blocks as TB
from ezpz_tpu_torch.ops.fleet_plan import plan_fleet
from ezpz_tpu_torch.ops.fused_fleet import (fused_fleet_reference,
                                            fused_fleet_solve)

from .test_torch_frontend import jax_system, port_system

B = 1024
# (fixture, bucket index, coarse trips, refine trips, fully constrained)
CASES = [
    ("massive_parallel_system", 0, 3, 2, True),
    ("massive_parallel_system", 1, 3, 2, True),
    ("square", 0, 4, 4, True),
    ("two_rectangles", 0, 4, 4, True),
    ("parc_coincident", 0, 4, 4, False),
]
IDS = [f"{c[0]}[{c[1]}]" for c in CASES]


def _inputs(bucket, x0, seed):
    """B lanes cycling over the bucket's components, guesses perturbed."""
    rng = np.random.default_rng(seed)
    k = np.arange(B) % len(bucket.components)
    xb = x0[bucket.var_index[k]] + rng.normal(0, 1e-3, (B, bucket.var_index.shape[1]))
    pars = [np.asarray(p)[k] for p in bucket.pars]
    return xb, pars


@pytest.fixture(scope="module")
def runs():
    """Both packages on every case, computed once for the module."""
    out = {}
    for seed, (name, bi, ct, rt, full) in enumerate(CASES):
        tc, x0 = port_system(name)
        jc, _ = jax_system(name)
        tb = TB.build_buckets(tc, len(x0))[bi]
        jb = JB.build_buckets(jc, len(x0))[bi]
        xb, pars = _inputs(tb, x0, seed)
        js = JBatchSolver(jb.system, JConfig(), batch_params=True,
                          precision="mixed", pallas_fused=True,
                          pallas_trips=ct, refine_trips=rt)
        jout = js.solve(jnp.asarray(xb), tuple(jnp.asarray(p) for p in pars))
        assert js._fused_runs[B] is not None, "JAX must take its fused kernel"
        ts = TBatchSolver(tb.system, TConfig(), batch_params=True,
                          precision="mixed", pallas_fused=True,
                          pallas_trips=ct, refine_trips=rt, device="cpu")
        tout = ts.solve(torch.as_tensor(xb), tuple(torch.as_tensor(p) for p in pars))
        jr, _ = jax.vmap(lambda x, *p: jb.system.residual_and_flags(x, p))(
            jnp.asarray(jout.x), *[jnp.asarray(p) for p in pars])
        tr, _ = tb.system.residual_and_flags(tout.x, tuple(torch.as_tensor(p) for p in pars))
        out[f"{name}[{bi}]"] = dict(
            full=full,
            j={k: np.asarray(getattr(jout, k)) for k in
               ("x", "iterations", "converged", "satisfied", "degenerate")},
            t={k: getattr(tout, k).numpy() for k in
               ("x", "iterations", "converged", "satisfied", "degenerate")},
            jr=np.asarray(jr), tr=tr.numpy(), solver=ts, xb=xb, pars=pars,
        )
    return out


def _clean(run):
    """Lanes without a NaN residual row in either package."""
    return ~(np.isnan(run["jr"]).any(axis=1) | np.isnan(run["tr"]).any(axis=1))


@pytest.mark.parametrize("case", IDS)
def test_flags_match_jax_kernel(runs, case):
    run = runs[case]
    ok = _clean(run)
    assert ok.mean() > 0.99
    for k in ("converged", "satisfied", "degenerate"):
        np.testing.assert_array_equal(run["t"][k][ok], run["j"][k][ok], err_msg=k)


@pytest.mark.parametrize("case", IDS)
def test_f64_residual_gate_where_jax_converged(runs, case):
    run = runs[case]
    conv = run["j"]["converged"]
    assert conv.mean() > 0.9, "the case should mostly converge"
    assert np.abs(run["jr"][conv]).max() <= 1e-8
    assert np.abs(run["tr"][conv]).max() <= 1e-8


@pytest.mark.parametrize("case", IDS)
def test_iterations_match_within_one(runs, case):
    run = runs[case]
    diff = np.abs(run["t"]["iterations"].astype(int) - run["j"]["iterations"].astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99


@pytest.mark.parametrize("case", [i for i, c in zip(IDS, CASES) if c[4]])
def test_coordinates_match_on_fully_constrained(runs, case):
    run = runs[case]
    both = run["t"]["converged"] & run["j"]["converged"]
    assert both.any()
    np.testing.assert_allclose(run["t"]["x"][both], run["j"]["x"][both], atol=1e-6)


@pytest.mark.parametrize("case", IDS)
def test_cpu_wrapper_takes_plain_version(runs, case):
    """On CPU tensors ``fused_fleet_solve`` is exactly the plain version
    and launches nothing."""
    from ezpz_tpu_torch.ops import fused_fleet

    run = runs[case]
    solver = run["solver"]
    x0 = torch.as_tensor(run["xb"][:64])
    pars = tuple(torch.as_tensor(p[:64]) for p in run["pars"])
    before = fused_fleet.LAUNCHES
    got = fused_fleet_solve(solver.plan, x0, pars, **solver.settings())
    want = fused_fleet_reference(solver.plan, x0, pars, **solver.settings())
    assert fused_fleet.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_degenerate_and_nan_rows():
    """A distance between coincident points is degenerate (both packages
    flag it); a NaN guess gives NaN residual rows, which the port reports
    unsatisfied and not converged."""
    from ezpz_tpu_torch.constraints import Constraint
    from ezpz_tpu_torch.datatypes import DatumPoint
    from ezpz_tpu_torch.models.compiled import compile_system

    p0, p1 = DatumPoint(0, 1), DatumPoint(2, 3)
    system = compile_system([Constraint.Fixed(0, 0.0), Constraint.Fixed(1, 0.0),
                             Constraint.Distance(p0, p1, 2.0)], n_vars=4)
    x0 = torch.zeros((3, 4), dtype=torch.float64)
    x0[2, 3] = float("nan")
    pars = tuple(torch.as_tensor(b.par).expand(3, -1, -1) for b in system.blocks)
    out = TBatchSolver(system, TConfig(), batch_params=True, precision="mixed",
                       pallas_fused=True, device="cpu").solve(x0, pars)
    assert out.degenerate[:2, 2].all() and not out.degenerate[:, :2].any()
    assert not out.satisfied[2, 2] and not out.converged[2]


def test_unsupported_modes_raise():
    """What the port refuses: a kernel mode without per-sketch parameters
    or in f64 (the JAX package asserts there too), an unknown precision,
    ``solve_analysis`` of a system with no rows (``EmptySystemNotAllowed``,
    as in the JAX package), and a non-f64 ``x0`` at the kernel wrapper."""
    from ezpz_tpu_torch.utils.errors import EmptySystemNotAllowed

    from ezpz_tpu_torch.models.compiled import compile_system
    from ezpz_tpu_torch.constraints import Constraint

    system = compile_system([Constraint.Fixed(0, 1.0)], n_vars=1)
    for kw in (dict(precision="mixed", pallas_fused=True),
               dict(precision="mixed", pallas_coarse=True),
               dict(batch_params=True, precision="f64", pallas_fused=True),
               dict(batch_params=True, precision="f64", pallas_coarse=True),
               dict(precision="f32")):
        with pytest.raises(ValueError):
            TBatchSolver(system, TConfig(), device="cpu", **kw)
    solver = TBatchSolver(system, TConfig(), batch_params=True,
                          precision="mixed", pallas_fused=True, device="cpu")
    x0 = torch.zeros((2, 1), dtype=torch.float64)
    pars = (torch.ones((2, 1, 1), dtype=torch.float64),)
    with pytest.raises(EmptySystemNotAllowed):
        TBatchSolver(compile_system([], n_vars=1), TConfig(), batch_params=True,
                     precision="mixed", pallas_fused=True,
                     device="cpu").solve_analysis(x0, ())
    with pytest.raises(ValueError):
        solver.solve(x0)
    with pytest.raises(ValueError):
        fused_fleet_solve(plan_fleet(system), x0.float(), pars, **solver.settings())


def test_default_device_is_the_card():
    """Without ``device``, ``BatchSolver`` solves on the GPU; on a machine
    without one it raises instead of answering on the CPU."""
    from ezpz_tpu_torch.models.compiled import compile_system
    from ezpz_tpu_torch.constraints import Constraint

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: tests/test_torch_cuda.py covers it")
    system = compile_system([Constraint.Fixed(0, 1.0)], n_vars=1)
    x0 = np.zeros((2, 1))
    pars = (np.ones((2, 1, 1)),)
    for kw in (dict(), dict(precision="mixed"),
               dict(batch_params=True, precision="mixed", pallas_coarse=True),
               dict(batch_params=True, precision="mixed", pallas_fused=True)):
        solver = TBatchSolver(system, TConfig(), **kw)
        assert solver.device == torch.device("cuda")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            solver.solve(x0, pars)
