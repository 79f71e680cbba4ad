"""The fleet kernels' gate and the planner's kernel tables, on the CPU.

* The port's gate (``fleet_plan.kernel_admits``) admits exactly what the
  JAX ``BatchSolver._pallas_topology_ok`` admits: at most 256 instances and
  a planned fill of at most 2080. Only the symbolic planners run (no kernel,
  no JAX compile).
* A topology outside the gate is answered in the kernel modes by the
  batched mixed path, bit for bit, and the kernel wrappers called on its
  plan raise, on the CPU as on the card.
* The planner's kernel tables say what the plain version does: every
  instance pair lands on the factor slot of its (permuted) entry, and the
  Crout factorization and both triangular solves run from the schedules
  give the plain version's ``damped_solve`` bit for bit.
"""

import numpy as np
import pytest
import torch

import ezpz_tpu as JPKG
import ezpz_tpu_torch as TPKG
from ezpz_tpu.batch import BatchSolver as JBatchSolver
from ezpz_tpu.models.compiled import compile_system as j_compile
from ezpz_tpu_torch.batch import BatchSolver
from ezpz_tpu_torch.config import Config
from ezpz_tpu_torch.models.blocks import build_buckets
from ezpz_tpu_torch.models.compiled import compile_system as t_compile
from ezpz_tpu_torch.ops import _build, coarse_fleet, fused_fleet
from ezpz_tpu_torch.ops.fleet_common import Topology, damped_solve
from ezpz_tpu_torch.ops.fleet_plan import (KI_IDS, KI_NV, KI_SLOTS, MAX_NV,
                                           kernel_admits, plan_fleet)

from .test_torch_frontend import port_system


def chain(pkg, n_points):
    """A pinned chain of unit distances: 2 n_points variables and
    instances."""
    ids = pkg.IdGenerator()
    pts = [pkg.DatumPoint.new(ids) for _ in range(n_points)]
    cons = [pkg.Constraint.Fixed(pts[0].id_x(), 0.0),
            pkg.Constraint.Fixed(pts[0].id_y(), 0.0)]
    for a, b in zip(pts, pts[1:]):
        cons += [pkg.Constraint.Distance(a, b, 1.0),
                 pkg.Constraint.Horizontal(pkg.DatumLineSegment(a, b))]
    x0 = np.zeros(2 * n_points)
    x0[0::2] = np.arange(n_points) + 0.01 * (-1.0) ** np.arange(n_points)
    return cons, x0


def rect_chain(pkg, R):
    """R rectangles chained corner to corner: 6R+2 constraints, 2(3R+1)
    variables."""
    ids = pkg.IdGenerator()
    pts = [pkg.DatumPoint.new(ids) for _ in range(3 * R + 1)]
    cons = [pkg.Constraint.Fixed(pts[0].id_x(), 1.0),
            pkg.Constraint.Fixed(pts[0].id_y(), 1.0)]
    for k in range(R):
        s, u, v, w = pts[3 * k:3 * k + 4]
        cons += [pkg.Constraint.Horizontal(pkg.DatumLineSegment(s, u)),
                 pkg.Constraint.Vertical(pkg.DatumLineSegment(u, v)),
                 pkg.Constraint.Horizontal(pkg.DatumLineSegment(v, w)),
                 pkg.Constraint.Vertical(pkg.DatumLineSegment(w, s)),
                 pkg.Constraint.Distance(s, u, 4.0),
                 pkg.Constraint.Distance(s, w, 3.0)]
    return cons, np.zeros(2 * (3 * R + 1))


def equal_lengths(pkg, L):
    """L segments, every pair held to equal length: 4L variables coupled
    all to all by C(L, 2) eight-variable instances (a dense JtJ)."""
    ids = pkg.IdGenerator()
    segs = [pkg.DatumLineSegment(pkg.DatumPoint.new(ids), pkg.DatumPoint.new(ids))
            for _ in range(L)]
    cons = [pkg.Constraint.LinesEqualLength(a, b)
            for i, a in enumerate(segs) for b in segs[i + 1:]]
    return cons, np.zeros(4 * L)


TOPOLOGIES = {
    "chain(33)": (chain, 33),
    "chain(128)": (chain, 128),    # 256 instances: the gate's edge
    "chain(129)": (chain, 129),    # 258 instances: over it
    "rect_chain(8)": (rect_chain, 8),
    "rect_chain(42)": (rect_chain, 42),
    "rect_chain(43)": (rect_chain, 43),
    "equal_lengths(17)": (equal_lengths, 17),  # 136 instances, fill 2346
}


def systems(name):
    make, k = TOPOLOGIES[name]
    tcons, x0 = make(TPKG, k)
    jcons, _ = make(JPKG, k)
    return t_compile(tcons, len(x0)), j_compile(jcons, len(x0)), x0


def jax_gate(jsys) -> bool:
    """The JAX BatchSolver's kernel gate, without building its solvers."""
    solver = JBatchSolver.__new__(JBatchSolver)
    solver.system = jsys
    return solver._pallas_topology_ok()


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_gate_matches_jax(name):
    tsys, jsys, _x0 = systems(name)
    want = jax_gate(jsys)
    assert kernel_admits(tsys) == want
    plan = plan_fleet(tsys)
    assert (plan.kernel is not None) == want
    expected = {"chain(129)": False, "rect_chain(43)": False,
                "equal_lengths(17)": False}.get(name, True)
    assert want == expected


def test_dense_topology_is_declined_by_fill():
    tsys, _jsys, _x0 = systems("equal_lengths(17)")
    plan = plan_fleet(tsys)
    assert plan.n_inst == 136 and plan.fill > 2080


def _over_gate_inputs(B=3, seed=0):
    cons, x0 = chain(TPKG, 129)
    system = t_compile(cons, len(x0))
    rng = np.random.default_rng(seed)
    xb = torch.as_tensor(x0 + rng.normal(0, 1e-3, (B, len(x0))))
    pars = tuple(torch.as_tensor(np.tile(b.par, (B, 1, 1))) for b in system.blocks)
    return system, xb, pars


@pytest.mark.parametrize("pallas_fused", [True, False])
def test_over_gate_takes_the_batched_mixed_path(pallas_fused):
    system, xb, pars = _over_gate_inputs()
    solver = BatchSolver(system, Config(), batch_params=True, precision="mixed",
                         pallas_coarse=True, pallas_fused=pallas_fused, device="cpu")
    assert not solver.kernel_ok and solver.plan is None
    got = solver.solve(xb, pars)
    want = BatchSolver(system, Config(), batch_params=True, precision="mixed",
                       device="cpu").solve(xb, pars)
    for name in ("x", "iterations", "converged", "satisfied", "degenerate"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert bool(got.converged.all())


def test_wrappers_raise_on_an_over_gate_plan():
    system, xb, pars = _over_gate_inputs()
    plan = plan_fleet(system)
    solver = BatchSolver(system, Config(), batch_params=True, precision="mixed",
                         pallas_fused=True, device="cpu")
    with pytest.raises(NotImplementedError, match="gate"):
        fused_fleet.fused_fleet_solve(plan, xb, pars, **solver.settings())
    with pytest.raises(NotImplementedError, match="gate"):
        coarse_fleet.coarse_fleet_solve(plan, xb, pars, **solver.coarse_settings())


def test_repeated_variable_takes_the_big_kernel():
    """The register layout needs distinct variables per instance; an
    instance naming one twice routes to the big-topology kernel."""
    p, q = TPKG.DatumPoint(0, 1), TPKG.DatumPoint(2, 3)
    system = t_compile([TPKG.Constraint.Fixed(0, 0.0), TPKG.Constraint.Fixed(1, 0.0),
                        TPKG.Constraint.Distance(p, q, 1.0),
                        TPKG.Constraint.Distance(q, q, 0.0)], n_vars=4)
    plan = plan_fleet(system)
    assert plan.kernel is not None and not plan.kernel["distinct_ids"]
    assert _build.small_shape(plan) is None


def _plans():
    out = {}
    for name, k in (("chain", 5), ("chain", 40), ("rect_chain", 8)):
        cons, x0 = (chain if name == "chain" else rect_chain)(TPKG, k)
        out[f"{name}({k})"] = plan_fleet(t_compile(cons, len(x0)))
    for fixture in ("two_rectangles", "underdetermined_lines", "chamfer_square"):
        cons, x0 = port_system(fixture)
        out[fixture] = plan_fleet(build_buckets(cons, len(x0))[0].system)
    return out


PLANS = _plans()


@pytest.mark.parametrize("name", list(PLANS))
def test_instance_pairs_land_on_their_factor_slots(name):
    plan = PLANS[name]
    k = plan.kernel
    inv = np.empty(plan.n_vars, np.int64)
    inv[plan.perm] = np.arange(plan.n_vars)
    row_of = np.repeat(np.arange(plan.n_vars), np.diff(k["row_start"]))
    slots = k["kinst"][:, KI_SLOTS:].copy().view(np.int16)
    for r, rec in enumerate(plan.inst):
        nv = int(rec[1])
        ids = [int(inv[j]) for j in rec[6:6 + nv]]
        assert list(k["kinst"][r, KI_IDS:KI_IDS + nv]) == ids
        assert k["kinst"][r, KI_NV] == nv
        for a in range(MAX_NV):
            for b in range(MAX_NV):
                q = int(slots[r, a * MAX_NV + b])
                if a < nv and b < nv and ids[a] >= ids[b]:
                    assert (row_of[q], k["ent_col"][q]) == (ids[a], ids[b])
                else:
                    assert q == -1


def schedule_solve(plan, A, jtr, lam):
    """The big-topology kernel's damped solve (csrc/fleet_common.cuh,
    BigLane::solve) on packed slots, in eager torch: the step in the
    elimination numbering and the fail flags."""
    k = plan.kernel
    rs, ec = k["row_start"].tolist(), k["ent_col"].tolist()
    cs, cp = k["cr_start"].tolist(), k["cr_pair"].tolist()
    cst, ce = k["col_start"].tolist(), k["col_ent"].tolist()
    n = plan.n_vars
    A = list(A)

    def diag(i):
        return rs[i + 1] - 1

    maxdiag = torch.abs(A[0])
    for i in range(1, n):
        maxdiag = torch.maximum(maxdiag, torch.abs(A[diag(i)]))
    lam_eff = torch.maximum(lam, maxdiag * 1e-6)
    for i in range(n):
        A[diag(i)] = A[diag(i)] + lam_eff
    for i in range(n):
        for e in range(rs[i], rs[i + 1]):
            s = A[e]
            for q in range(cs[e], cs[e + 1]):
                s = s - A[cp[q] & 0xFFFF] * A[cp[q] >> 16]
            A[e] = torch.sqrt(s) if e == diag(i) else s / A[diag(ec[e])]
    fail = torch.isnan(A[0])
    for i in range(1, n):
        fail = fail | torch.isnan(A[diag(i)])
    for i in range(n):
        for e in range(rs[i], diag(i)):
            A[e] = torch.where(torch.isnan(A[e]), 0.0, A[e])
        d = A[diag(i)]
        A[diag(i)] = torch.where(torch.isnan(d) | (d == 0.0), 1.0, d)
    y = [None] * n
    for i in range(n):
        s = -jtr[i]
        for e in range(rs[i], diag(i)):
            s = s - A[e] * y[ec[e]]
        y[i] = s / A[diag(i)]
    for i in reversed(range(n)):
        s = y[i]
        for q in range(cst[i], cst[i + 1]):
            s = s - A[ce[q] & 0xFFFF] * y[ce[q] >> 16]
        y[i] = s / A[diag(i)]
    return [torch.where(fail, 0.0, yi) for yi in y], fail


@pytest.mark.parametrize("name", list(PLANS))
def test_crout_schedule_matches_plain_solve(name):
    plan = PLANS[name]
    k = plan.kernel
    n, B = plan.n_vars, 32
    rng = np.random.default_rng(7)
    topo = Topology(plan)
    entries = [(i, int(j)) for i in range(n) for j in k["ent_col"][k["row_start"][i]:
                                                                   k["row_start"][i + 1]]]
    A = {}
    for (i, j) in entries:
        v = rng.normal(0, 1, B).astype(np.float32)
        if i == j:
            v = np.abs(v) + 4.0
        if (i, j) == entries[len(entries) // 2] and i != j:
            v[0] = np.nan  # one lane carries a NaN through the factor
        A[i, j] = torch.as_tensor(v)
    jtr_orig = [torch.as_tensor(rng.normal(0, 1, B).astype(np.float32)) for _ in range(n)]
    lam = torch.full((B,), 1e-3, dtype=torch.float32)
    want, want_fail = damped_solve(topo, dict(A), jtr_orig, lam)
    got, got_fail = schedule_solve(plan, [A[e] for e in entries],
                                   [jtr_orig[int(v)] for v in plan.perm], lam)
    assert torch.equal(got_fail, want_fail)
    for kpos, v in enumerate(plan.perm):
        a, b = got[kpos], want[int(v)]
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
