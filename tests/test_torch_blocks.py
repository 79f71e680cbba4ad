"""The port's decomposed solvers against the JAX package's, on the CPU.

* ``BlockSolver`` in f64, mixed, ``pallas_coarse`` and ``pallas_fused``
  (the kernels' plain versions here; the JAX kernels in interpret mode) on
  the 12-block fleet of ``tests/test_block_api.py`` with ``q.x`` pinned
  (so the blocks are fully constrained) and one degenerate block (not in
  the mixed mode, where JAX's unrolled evaluator takes it elsewhere; see
  ``test_mixed_degenerate_block_follows_the_compiled_evaluator``):
  converged, satisfied and degenerate flags equal; iterations equal in
  f64 and through the fused kernel, within 1 on the batched mixed paths
  (XLA's fused f32 rounding, ``tests/test_torch_solver.py``); coordinates
  within 1e-9 in f64 and 1e-6 otherwise, outside the degenerate block.
* ``MultiTopologySolver`` against JAX's on the buckets of
  ``massive_parallel_system``.
* ``CompiledSystem.jacobian_dense`` and ``residual`` against JAX's within
  1e-12 (corpus fixtures at perturbed points, and an instance naming one
  variable twice), and ``BlockProgram.jacobian_dense`` likewise.
* ``BlockProgram.solver``'s packed outcome with per-call tolerances.
* ``solve_blocks``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import ezpz_tpu as J
import ezpz_tpu_torch as T
from ezpz_tpu.batch import MultiTopologySolver as JMulti
from ezpz_tpu.models import blocks as JB
from ezpz_tpu.models.compiled import compile_system as j_compile_system
from ezpz_tpu_torch.batch import MultiTopologySolver as TMulti
from ezpz_tpu_torch.models import blocks as TB
from ezpz_tpu_torch.models.compiled import compile_system as t_compile_system

from .test_torch_api import _fleet
from .test_torch_frontend import jax_system, port_system

MODES = {
    "f64": dict(precision="f64"),
    "mixed": dict(precision="mixed"),
    "coarse": dict(precision="mixed", pallas_coarse=True),
    "fused": dict(precision="mixed", pallas_fused=True),
}


def _constraints(ez, pinned=False, **kw):
    """The fleet's constraints with resolved sides, and its guesses;
    ``pinned`` adds ``Fixed(q.x)`` to every block, so that each block but
    the degenerate one is fully constrained."""
    reqs, guesses = _fleet(ez, **kw)
    x0 = np.zeros(len(guesses))
    for vid, val in guesses:
        x0[vid] = val
    cons = [r.constraint.set_from_initial_values(x0) for r in reqs]
    if pinned:
        cons += [ez.Constraint.Fixed(c.payload["p1"].x_id, x0[c.payload["p1"].x_id])
                 for c in cons if c.kind == ez.Constraint.DISTANCE]
    return cons, x0


@pytest.mark.parametrize("mode", list(MODES))
def test_block_solver_matches_jax(mode):
    # The degenerate block's mixed trajectory depends on the evaluator:
    # JAX's BatchSolver evaluates a topology of at most 24 instances with
    # its unrolled evaluator, the port with the compiled one (21 trips
    # unconverged, as JAX's own compiled-system loop; JAX's BlockSolver 17
    # converged). That mode runs the fleet without it; the difference is
    # pinned in test_mixed_degenerate_block_follows_the_compiled_evaluator.
    degenerate_at = None if mode == "mixed" else 3
    tc, x0 = _constraints(T, pinned=True, degenerate_at=degenerate_at)
    jc, _ = _constraints(J, pinned=True, degenerate_at=degenerate_at)
    solver = TB.BlockSolver(tc, len(x0), device="cpu", **MODES[mode])
    t = solver.solve(x0)
    j = JB.BlockSolver(jc, len(x0), **MODES[mode]).solve(x0)
    assert (t.n_components, t.n_buckets) == (j.n_components, j.n_buckets) == (
        12, 1 if degenerate_at is None else 2)
    assert t.converged == j.converged
    np.testing.assert_array_equal(t.satisfied, np.asarray(j.satisfied))
    np.testing.assert_array_equal(t.degenerate, np.asarray(j.degenerate))
    assert np.flatnonzero(t.degenerate).tolist() == ([] if degenerate_at is None else [12])
    if mode in ("f64", "fused"):
        assert t.iterations == j.iterations
    else:
        assert abs(t.iterations - j.iterations) <= 1
    # Coordinates on the fully constrained blocks: all but the degenerate
    # block's mirrored points (ids 16-19).
    keep = np.ones(len(x0), dtype=bool)
    keep[16:20] = degenerate_at is None
    np.testing.assert_allclose(t.x[keep], np.asarray(j.x)[keep], rtol=0,
                               atol=1e-9 if mode == "f64" else 1e-6)
    assert isinstance(t.x, np.ndarray) and t.x.dtype == np.float64


def test_mixed_degenerate_block_follows_the_compiled_evaluator():
    """The one place where the port's batched mixed path and JAX's
    ``BlockSolver`` part (ROADMAP.md section 3, item 5), pinned with its
    cause. The degenerate block (8 variables, 5 instances) runs 21 trips
    unconverged in the port and 17 converged in JAX's ``BlockSolver``.
    JAX's own ``solve_lm_mixed`` on the compiled system, jitted, runs the
    port's 21 trips unconverged; only JAX's ``BatchSolver`` reaches 17,
    because it evaluates topologies of at most 24 instances through its
    unrolled evaluator (``_maybe_unroll``, ezpz_tpu/batch.py:80-86), whose
    f32 coarse phase ends at another point (its unsatisfiable mirror
    residual stays at 6.0 either way). That evaluator was chosen by TPU
    measurements and is not ported (ROADMAP.md queue 1 item 7)."""
    from ezpz_tpu import solver as JS
    from ezpz_tpu.batch import _maybe_unroll
    from ezpz_tpu_torch import solver as TS

    jc, x0 = _constraints(J, pinned=True, degenerate_at=3)
    tc, _ = _constraints(T, pinned=True, degenerate_at=3)
    jb = [b for b in JB.build_buckets(jc, len(x0)) if b.system.n_vars == 8][0]
    tb = [b for b in TB.build_buckets(tc, len(x0)) if b.system.n_vars == 8][0]
    np.testing.assert_array_equal(jb.var_index, tb.var_index)
    xb = x0[jb.var_index]
    c = J.Config()
    args = (c.max_iterations, c.residual_tolerance, c.step_tolerance, c.initial_lambda)

    def jax_mixed(s64):
        s32 = s64.astype(jnp.float32)
        return jax.jit(jax.vmap(lambda x: JS.solve_lm_mixed(s64, s32, x, *args)))(
            jnp.asarray(xb))

    compiled = jax_mixed(jb.system)
    port = TS.solve_lm_mixed(tb.system, tb.system.astype(torch.float32),
                             torch.as_tensor(xb), *args)
    assert int(compiled.iterations[0]) == int(port.iterations[0]) == 21
    assert not bool(compiled.converged[0]) and not bool(port.converged[0])
    ev64 = _maybe_unroll(jb.system)
    assert type(ev64).__name__ == "UnrolledSystem"
    s32 = _maybe_unroll(jb.system.astype(jnp.float32))
    unrolled = jax.jit(jax.vmap(lambda x: JS.solve_lm_mixed(ev64, s32, x, *args)))(
        jnp.asarray(xb))
    assert int(unrolled.iterations[0]) == 17 and bool(unrolled.converged[0])
    t = TB.BlockSolver(tc, len(x0), precision="mixed", device="cpu").solve(x0)
    j = JB.BlockSolver(jc, len(x0), precision="mixed").solve(x0)
    assert (t.iterations, t.converged) == (21, False)
    assert (j.iterations, j.converged) == (17, True)


def test_block_solver_kernel_modes_apply_only_in_mixed():
    """As in the JAX package, ``pallas_*`` with ``precision="f64"`` runs
    the plain f64 loop in every bucket."""
    tc, x0 = _constraints(T)
    solver = TB.BlockSolver(tc, len(x0), precision="f64", pallas_fused=True, device="cpu")
    assert not any(s.pallas_fused or s.pallas_coarse for s in solver._solvers)
    assert solver.solve(x0).converged


def test_solve_blocks_matches_block_solver():
    tc, x0 = _constraints(T, inconsistent_at=5)
    a = TB.solve_blocks(tc, x0, device="cpu")
    b = TB.BlockSolver(tc, len(x0), device="cpu").solve(x0)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.satisfied, b.satisfied)
    assert (a.iterations, a.converged) == (b.iterations, b.converged)
    assert set(np.flatnonzero(~a.satisfied)) <= {15, 16, 17, 18}


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_multi_topology_solver_matches_jax(precision):
    tc, x0 = port_system("massive_parallel_system")
    jc, _ = jax_system("massive_parallel_system")
    tbk = TB.build_buckets(tc, len(x0))
    jbk = JB.build_buckets(jc, len(x0))
    x0s = [x0[b.var_index] + 1e-3 for b in tbk]
    touts = TMulti([b.system for b in tbk], T.Config(), precision=precision,
                   device="cpu").solve(x0s, [b.pars for b in tbk])
    jouts = JMulti([b.system for b in jbk], J.Config(), precision=precision).solve(
        [jnp.asarray(x) for x in x0s], [tuple(jnp.asarray(p) for p in b.pars) for b in jbk])
    assert len(touts) == len(jouts) == 2
    for t, j in zip(touts, jouts):
        for name in ("converged", "satisfied", "degenerate"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)), err_msg=name)
        it_t, it_j = t.iterations.numpy(), np.asarray(j.iterations)
        if precision == "f64":
            np.testing.assert_array_equal(it_t, it_j)
            np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0, atol=1e-12)
        else:
            assert np.abs(it_t.astype(int) - it_j.astype(int)).max() <= 1
            np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["arc_length", "chamfer_square", "circle_tangent",
                                  "parc_coincident", "symmetric", "underdetermined_lines"])
def test_jacobian_dense_matches_jax(name):
    tc, x0 = port_system(name)
    jc, _ = jax_system(name)
    t = t_compile_system(tc, len(x0))
    j = j_compile_system(jc, len(x0))
    rng = np.random.default_rng(3)
    xs = x0[None] + rng.normal(0, 0.1, (5, len(x0)))
    got = t.jacobian_dense(torch.as_tensor(xs)).numpy()
    want, want_r = jax.jit(jax.vmap(lambda x: (j.jacobian_dense(x), j.residual(x))))(
        jnp.asarray(xs))
    assert got.shape == (5, t.n_rows, t.n_vars)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t.residual(torch.as_tensor(xs)).numpy(), np.asarray(want_r),
                               rtol=0, atol=1e-12)


def test_jacobian_dense_adds_a_repeated_variable():
    """Symmetric about the segment (p, p) names p's ids twice: both
    derivatives add into one column, as JAX's scatter-add does; per-sketch
    parameters override the compiled ones."""
    tc, x0 = _constraints(T, K=2, degenerate_at=1)
    jc, _ = _constraints(J, K=2, degenerate_at=1)
    t = t_compile_system(tc, len(x0))
    j = j_compile_system(jc, len(x0))
    assert any(len(set(inst.var_ids)) < len(inst.var_ids)
               for c in tc for inst in c.lower())
    xs = x0[None] + np.random.default_rng(5).normal(0, 0.2, (3, len(x0)))
    pars = tuple(np.tile(p, (3, 1, 1)) * 1.5 for p in t.param_arrays())
    got = t.jacobian_dense(torch.as_tensor(xs), tuple(torch.as_tensor(p) for p in pars))
    want = jax.vmap(j.jacobian_dense)(jnp.asarray(xs), tuple(jnp.asarray(p) for p in pars))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_block_program_jacobian_matches_jax():
    tc, x0 = _constraints(T, degenerate_at=3)
    jc, _ = _constraints(J, degenerate_at=3)
    x = x0 + np.random.default_rng(9).normal(0, 0.1, len(x0))
    got = TB.BlockProgram(tc, len(x0), device="cpu").jacobian_dense(x)
    want = JB.BlockProgram(jc, len(x0)).jacobian_dense(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("tols", [(1e-8, 1e-8, 1e-9), (1e-3, 1e-3, 1e-2)])
def test_block_program_solver_matches_jax(tols):
    """``BlockProgram.solver`` takes the tolerances of each call, as JAX's
    does: the same packed outcome at the defaults and at loose tolerances
    (which stop earlier and leave constraints unsatisfied)."""
    tc, x0 = _constraints(T, pinned=True, degenerate_at=3)
    jc, _ = _constraints(J, pinned=True, degenerate_at=3)
    n = len(x0)
    got = TB.BlockProgram(tc, n, device="cpu").solver(x0, *tols).numpy()
    want = np.asarray(JB.BlockProgram(jc, n).solver(jnp.asarray(x0), *tols))
    np.testing.assert_array_equal(got[n:], want[n:])  # sat, deg, converged, iterations
    np.testing.assert_allclose(got[:n], want[:n], rtol=0, atol=1e-12)
    assert got[-1] == (4 if tols[0] == 1e-8 else 5)
