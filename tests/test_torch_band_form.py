"""The band tier keeps JtJ in band form (``CompiledSystem.band_plan``,
``ops/banded.BandRoute``, ``solver.damped_band_solve``), on the CPU.

The band route assembles JtJ straight into its (B, n, bw+1) lower band and
adds lambda to the band's diagonal column; the dense route assembles the
(B, n, n) matrix, adds ``lam * I`` and gathers the band from it
(``make_banded_spd``). Each band entry takes the dense entry's
contribution list in the same order, and ``lam * I`` adds exact zeros off
the diagonal, so the factor sees the same values on both routes: x,
iterations and every flag must be ``torch.equal``, not close.

Topologies: ``rect_chain(8)`` (identity ordering, bw 7), ``rect_grid(5,
5)`` (identity, bw 13), the over-gate ``rect_chain(43)``, and
``rect_chain(8)`` with its variable ids relabelled through a seeded
permutation, whose plan is an RCM ordering (``perm`` not None), so that
the permuted band plan and b's and x's permutations are exercised. Modes:
``solve_lm`` in f64 and on the f32 twin (the f32 retry), and
``solve_lm_mixed``. B = 8 lanes moved by seeded N(0, 0.05).

On the CPU ``damped_band_solve`` is ``damped_band_composed`` (the card's
one-launch path is held to it in ``tests/test_torch_cuda.py``), and a
``BatchSolver`` band-tier solve keeps the dense witness's flags,
iterations and x.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ezpz_tpu_torch import fixtures, tracing
from ezpz_tpu_torch.batch import BatchSolver, _pick_spd
from ezpz_tpu_torch.config import Config
from ezpz_tpu_torch.models.compiled import compile_system
from ezpz_tpu_torch.ops import banded
from ezpz_tpu_torch.solver import (damped_band_composed, damped_band_solve, damped_spd_solve,
                                   solve_lm, solve_lm_mixed)

B = 8


def _relabelled(system, x0, seed):
    """``system`` with variable v renamed q[v] for a seeded permutation q,
    and x0 moved to match."""
    q = np.random.default_rng(seed).permutation(system.n_vars)
    blocks = tuple(dataclasses.replace(b, idx=q[b.idx].astype(np.int32))
                   for b in system.blocks)
    x = np.empty_like(x0)
    x[q] = x0
    return dataclasses.replace(system, blocks=blocks), x


def _topology(name):
    """(system, x0, route, plan) of a named topology."""
    if name.startswith("rect_chain"):
        cons, x0 = fixtures.rect_chain(43 if "43" in name else 8)
    else:
        cons, x0 = fixtures.rect_grid(5, 5)
    system = compile_system(cons, len(x0))
    if name.endswith("relabelled"):
        system, x0 = _relabelled(system, x0, seed=11)
    plan = banded.plan_band(system)
    route = _pick_spd(system)
    assert isinstance(route, banded.BandRoute) and route.bw == plan[1]
    return system, x0, route, plan


TOPOLOGIES = {"rect_chain(8)": 7, "rect_grid(5,5)": 13, "rect_chain(43)": 7,
              "rect_chain(8) relabelled": 14}  # RCM of the relabelled ids


@pytest.mark.parametrize("mode", ["f64", "f32", "mixed"])
@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_band_route_equals_the_dense_route(name, mode):
    system, x0, route, (perm, bw) = _topology(name)
    assert bw == TOPOLOGIES[name]
    assert (perm is not None) == name.endswith("relabelled")
    dense = banded.make_banded_spd(system.n_vars, bw, perm)
    rng = np.random.default_rng(len(x0))
    x = torch.as_tensor(x0 + rng.normal(0.0, 0.05, (B, len(x0))))
    c = Config()
    args = (c.max_iterations, c.residual_tolerance, c.step_tolerance, c.initial_lambda)
    sys32 = system.astype(torch.float32)
    run = {"f64": lambda spd: solve_lm(system, x, *args, spd=spd),
           "f32": lambda spd: solve_lm(sys32, x.float(), *args, spd=spd),
           "mixed": lambda spd: solve_lm_mixed(system, sys32, x, *args, spd=spd)}[mode]
    got, want = run(route), run(dense)
    for field in got._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert bool(got.converged.all())


@pytest.mark.parametrize("name", ["rect_chain(8)", "rect_chain(8) relabelled"])
def test_damped_band_solve_takes_the_f32_retry(name):
    """``damped_band_solve`` against ``damped_spd_solve`` on the same f32
    normal equations: lane 1's raw damping (-1) fails and the floored one
    solves it; lane 2's NaN damping fails both; the others solve raw."""
    system, x0, route, (perm, bw) = _topology(name)
    sys32 = system.astype(torch.float32)
    rng = np.random.default_rng(5)
    x = torch.as_tensor(x0 + rng.normal(0.0, 0.05, (B, len(x0))))
    _r, jtj, jtr, _d = sys32.normal_equations(x)
    _r, band, jtr_b, _d = sys32.normal_equations(x, band=route)
    assert band.shape == (B, system.n_vars, bw + 1) and torch.equal(jtr_b, jtr)
    lam = torch.full((B,), 1e-3, dtype=torch.float32)
    lam[1], lam[2] = -1.0, float("nan")
    raw = band.clone()
    raw[..., bw] += lam[:, None]
    assert route.solve(raw, -jtr)[1].tolist() == [k in (1, 2) for k in range(B)]
    d, fail = damped_band_solve(band, lam, -jtr, route)
    want_d, want_fail = damped_spd_solve(jtj, lam, -jtr,
                                         spd=banded.make_banded_spd(system.n_vars, bw, perm))
    assert torch.equal(d, want_d) and torch.equal(fail, want_fail)
    assert fail.tolist() == [k == 2 for k in range(B)]
    assert bool((d[1] != 0).any()) and bool((d[2] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["rect_chain(8)", "rect_chain(8) relabelled"])
def test_damped_band_solve_on_the_cpu_is_the_composition(name, dtype):
    """On the CPU ``damped_band_solve`` launches nothing and counts no
    ``lm.band_damped``: it is ``damped_band_composed``, torch.equal, with
    the lanes of the f32 retry (lambda -1 and NaN) among them."""
    system, x0, route, (_perm, _bw) = _topology(name)
    sys_t = system.astype(dtype)
    rng = np.random.default_rng(9)
    x = torch.as_tensor(x0 + rng.normal(0.0, 0.05, (B, len(x0))))
    _r, band, jtr, _d = sys_t.normal_equations(x.to(dtype), band=route)
    lam = torch.full((B,), 1e-3, dtype=dtype)
    lam[1], lam[2] = -1.0, float("nan")
    before = tracing.counts().get("lm.band_damped", 0)
    d, fail = damped_band_solve(band, lam, -jtr, route)
    assert tracing.counts().get("lm.band_damped", 0) == before
    want_d, want_fail = damped_band_composed(band, lam, -jtr, route)
    assert torch.equal(d, want_d) and torch.equal(fail, want_fail)
    assert bool(fail[2]) and not bool(fail[0])


@pytest.mark.parametrize("name", ["rect_chain(8)", "rect_chain(8) relabelled"])
def test_batch_solver_band_tier_keeps_the_dense_witness(name):
    """A mixed ``BatchSolver`` on the band tier answers as
    ``solve_lm_mixed`` with the dense JtJ and ``make_banded_spd`` (the dense
    witness): iterations, every flag and x torch.equal."""
    system, x0, route, (perm, bw) = _topology(name)
    solver = BatchSolver(system, Config(), precision="mixed", device="cpu")
    assert isinstance(solver.spd, banded.BandRoute)
    rng = np.random.default_rng(13)
    x = torch.as_tensor(x0 + rng.normal(0.0, 0.05, (B, len(x0))))
    got = solver.solve(x)
    c = Config()
    want = solve_lm_mixed(system, system.astype(torch.float32), x, c.max_iterations,
                          c.residual_tolerance, c.step_tolerance, c.initial_lambda,
                          spd=banded.make_banded_spd(system.n_vars, bw, perm))
    assert torch.equal(got.iterations, want.iterations)
    assert torch.equal(got.converged, want.converged)
    assert torch.equal(got.degenerate, want.deg)
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.satisfied, system.satisfaction(want.x, want.residual))
    assert bool(got.converged.all())


def test_band_plan_refuses_entries_outside_the_band():
    system, _x0, _route, (perm, bw) = _topology("rect_chain(8) relabelled")
    with pytest.raises(ValueError, match="outside the band"):
        system.band_plan(None, bw)
    entries, gather, size = system.band_plan(perm, bw)
    assert size == system.n_vars * (bw + 1) and len(entries) == len(gather)
