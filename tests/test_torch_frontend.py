"""The port's front end against the JAX package on all 28 corpus fixtures:
parser, executor, ``compile_system``, ``from_reference``,
``build_buckets``, the fleet planner and ``residual_and_flags``.

Every fixture is parsed by both packages from the same text. Structural
results (instructions, lowered instances, index and parameter arrays,
bucket order, ``var_index``, permutation and fill) must be exactly equal.
f64 residuals are compared to 1e-12 (the same IEEE operations, in the same
order, on both sides). A subprocess test shows the package loads no JAX.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ezpz_tpu.models import blocks as JB
from ezpz_tpu.models import compiled as JC
from ezpz_tpu.ops import pallas_fleet as JP
from ezpz_tpu.textual import parser as JPARSE
from ezpz_tpu_torch.models import blocks as TB
from ezpz_tpu_torch.models import compiled as TC
from ezpz_tpu_torch.ops import fleet_plan as TP
from ezpz_tpu_torch.ops.kernels import KERNELS
from ezpz_tpu_torch.textual import Problem as TProblem
from ezpz_tpu_torch.textual import parser as TPARSE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = os.path.join(ROOT, "tests", "cases")
FIXTURES = sorted(
    d for d in os.listdir(CASES)
    if os.path.exists(os.path.join(CASES, d, "problem.md"))
)


def fixture_text(name):
    with open(os.path.join(CASES, name, "problem.md")) as fh:
        return fh.read()


def port_system(name):
    """(constraints with resolved sides, x0) through the port's front end."""
    cs = TProblem.from_str(fixture_text(name)).to_constraint_system()
    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val
    return [r.constraint.set_from_initial_values(x0) for r in cs.constraints], x0


def jax_system(name):
    from ezpz_tpu.textual.executor import to_constraint_system

    problem = JPARSE._parse_problem_py(fixture_text(name))
    cs = to_constraint_system(problem)
    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val
    return [r.constraint.set_from_initial_values(x0) for r in cs.constraints], x0


def reference_fields(system):
    """A JAX CompiledSystem as the plain data ``from_reference`` takes."""
    return {
        "n_vars": system.n_vars,
        "n_constraints": system.n_constraints,
        "n_rows": system.n_rows,
        "blocks": [(b.spec.name, np.asarray(b.idx), np.asarray(b.par),
                    np.asarray(b.weight), np.asarray(b.cid)) for b in system.blocks],
    }


def _instr_tuple(i):
    return (i.op, tuple(i.labels), i.value,
            None if i.component is None else i.component.value,
            None if i.angle is None else (i.angle.val, i.angle.degrees))


def test_corpus_has_28_fixtures():
    assert len(FIXTURES) == 28


@pytest.mark.parametrize("name", FIXTURES)
def test_parser_matches_reference(name):
    txt = fixture_text(name)
    a = TPARSE.parse_problem(txt)
    b = JPARSE._parse_problem_py(txt)
    assert [_instr_tuple(i) for i in a.instructions] == [
        _instr_tuple(i) for i in b.instructions]
    for field in ("inner_points", "inner_circles", "inner_arcs", "inner_lines"):
        assert getattr(a, field) == getattr(b, field), field
    assert [(g.point, g.x, g.y) for g in a.point_guesses] == [
        (g.point, g.x, g.y) for g in b.point_guesses]
    assert [(g.scalar, g.guess) for g in a.scalar_guesses] == [
        (g.scalar, g.guess) for g in b.scalar_guesses]


@pytest.mark.parametrize("name", FIXTURES)
def test_executor_and_lowering_match_reference(name):
    tc, tx = port_system(name)
    jc, jx = jax_system(name)
    np.testing.assert_array_equal(tx, jx)
    assert [c.kind for c in tc] == [c.kind for c in jc]
    assert [c.dependent_variable_ids() for c in tc] == [
        c.dependent_variable_ids() for c in jc]
    assert [[(k.kernel, k.var_ids, k.params) for k in c.lower()] for c in tc] == [
        [(k.kernel, k.var_ids, k.params) for k in c.lower()] for c in jc]


def _assert_systems_equal(t, j):
    assert (t.n_vars, t.n_constraints, t.n_rows) == (j.n_vars, j.n_constraints, j.n_rows)
    assert [b.spec.name for b in t.blocks] == [b.spec.name for b in j.blocks]
    for tb, jb in zip(t.blocks, j.blocks):
        for f in ("idx", "par", "weight", "cid"):
            a, b = getattr(tb, f), np.asarray(getattr(jb, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("name", FIXTURES)
def test_compile_system_and_from_reference(name):
    tc, x0 = port_system(name)
    jc, _ = jax_system(name)
    t = TC.compile_system(tc, len(x0))
    j = JC.compile_system(jc, len(x0))
    _assert_systems_equal(t, j)
    _assert_systems_equal(TC.from_reference(reference_fields(j)), j)
    t32 = t.astype(torch.float32)
    _assert_systems_equal(t32, j.astype(jnp.float32))
    assert TC.from_reference(reference_fields(j.astype(jnp.float32))).dtype == torch.float32


@pytest.mark.parametrize("name", FIXTURES)
def test_residual_and_flags_match_reference(name):
    """f64 residual, degenerate and satisfaction flags at the fixture's
    guesses and at seeded perturbations of them (batched in the port,
    vmapped in JAX)."""
    tc, x0 = port_system(name)
    jc, _ = jax_system(name)
    t = TC.compile_system(tc, len(x0))
    j = JC.compile_system(jc, len(x0))
    rng = np.random.default_rng(7)
    xs = x0[None, :] + np.concatenate([np.zeros((1, len(x0))),
                                       rng.normal(0, 0.3, (15, len(x0)))])
    jr, jd, js = jax.jit(jax.vmap(
        lambda x: (*j.residual_and_flags(x),
                   j.satisfaction_from_residual(j.residual(x)))))(jnp.asarray(xs))
    tr, td = t.residual_and_flags(torch.as_tensor(xs))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(t.satisfaction_from_residual(tr).numpy(),
                                  np.asarray(js))


@pytest.mark.parametrize("name", FIXTURES)
def test_build_buckets_match_reference(name):
    tc, x0 = port_system(name)
    jc, _ = jax_system(name)
    tbk = TB.build_buckets(tc, len(x0))
    jbk = JB.build_buckets(jc, len(x0))
    assert len(tbk) == len(jbk)
    for t, j in zip(tbk, jbk):
        _assert_systems_equal(t.system, j.system)
        np.testing.assert_array_equal(t.var_index, j.var_index)
        np.testing.assert_array_equal(t.cid_index, j.cid_index)
        assert len(t.pars) == len(j.pars)
        for a, b in zip(t.pars, j.pars):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert [c.constraint_ids for c in t.components] == [
            c.constraint_ids for c in j.components]


@pytest.mark.parametrize("name", FIXTURES)
def test_planner_matches_reference(name):
    """Elimination order, symbolic fill and fill count equal the JAX
    planner's for every bucket; ``plan_fleet`` tables agree with them."""
    tc, x0 = port_system(name)
    jc, _ = jax_system(name)
    for t, j in zip(TB.build_buckets(tc, len(x0)), JB.build_buckets(jc, len(x0))):
        j32 = j.system.astype(jnp.float32)
        n = j32.n_vars
        jperm, jnz = JP._plan_factorization(JP._instance_list(j32), n)
        tinst = TP._instance_list(t.system)
        tperm, tnz = TP._plan_factorization(tinst, n)
        assert tperm == jperm
        assert tnz == jnz
        assert TP.jtj_fill_count(t.system) == JP.jtj_fill_count(j.system)
        assert TP.n_flag_words(n) == JP.n_flag_words(n)
        plan = TP.plan_fleet(t.system)
        np.testing.assert_array_equal(plan.nzl.astype(bool), np.asarray(jnz))
        np.testing.assert_array_equal(
            plan.perm, np.arange(n) if jperm is None else np.asarray(jperm))
        assert int(np.tril(plan.nzl).sum()) == TP.jtj_fill_count(t.system)
        jinst = JP._instance_list(j32)
        assert [(r[1], r[4], r[6]) for r in tinst] == [(r[1], r[4], r[6]) for r in jinst]
        assert [np.float32(r[5]) for r in tinst] == [r[5] for r in jinst]


@pytest.mark.parametrize("seed", range(6))
def test_planner_matches_reference_on_random_topologies(seed):
    """Random instance sets (the shapes of tests/test_planner_fuzz.py):
    permutation and fill equal, RCM and ND orders equal."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 40))
    insts = []
    for _ in range(int(rng.integers(2, 3 * n))):
        k = int(rng.integers(1, min(6, n) + 1))
        insts.append((None, sorted(set(int(v) for v in rng.integers(0, n, k)))))
    assert TP._plan_factorization(insts, n) == JP._plan_factorization(insts, n)
    pat = JP._jtj_pattern(insts, n)
    assert TP._jtj_pattern(insts, n) == pat
    assert TP._rcm_order(pat, n) == JP._rcm_order(pat, n)
    assert TP._nd_order(pat, n) == JP._nd_order(pat, n)
    assert TP._etree_fill(pat, n, limit=n + 5) == JP._etree_fill(pat, n, limit=n + 5)


def test_cuda_kind_enum_matches_registry():
    """The CUDA kernels' kind switch is numbered in registry order."""
    src = open(os.path.join(ROOT, "ezpz_tpu_torch", "csrc", "fleet_common.cuh")).read()
    enum = re.findall(r"^\s*K_(\w+) = (\d+),", src, flags=re.M)
    assert [(name, int(i)) for name, i in enum] == [
        (name, i) for i, name in enumerate(KERNELS)]


def test_cuda_capacities_match_build_module():
    """The exact-shape ladder of the CUDA source is the build module's,
    and each source dispatches every rung of it (small and occupancy
    entry points of both kernels)."""
    from ezpz_tpu_torch.ops import _build

    csrc = os.path.join(ROOT, "ezpz_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "fleet_common.cuh")).read()
    caps = re.search(r"constexpr int SMALL_SHAPES\[\]\[2\] = \{(.*?)\};", src).group(1)
    assert tuple(tuple(int(v) for v in c) for c in
                 re.findall(r"\{(\d+), (\d+)\}", caps)) == _build.SMALL_SHAPES
    for name in ("fused_fleet.cu", "coarse_fleet.cu"):
        body = open(os.path.join(csrc, name)).read()
        assert tuple((int(a), int(b)) for a, b in
                     re.findall(r"^\s*EZPZ_SMALL\((\d+), (\d+)\)$", body, flags=re.M)
                     ) == _build.SMALL_SHAPES * 2, name


@pytest.mark.parametrize("table", ["ARITY", "NPAR", "DIM"])
def test_cuda_kind_tables_match_registry(table):
    """Variables, parameters and rows per kind in the CUDA source are the
    registry's."""
    src = open(os.path.join(ROOT, "ezpz_tpu_torch", "csrc", "fleet_common.cuh")).read()
    body = re.search(rf"constexpr int {table}\[23\] = \{{(.*?)\}};", src, flags=re.S).group(1)
    field = {"ARITY": "nvars", "NPAR": "nparams", "DIM": "dim"}[table]
    assert [int(v) for v in body.replace("\n", " ").split(",")] == [
        getattr(spec, field) for spec in KERNELS.values()]


def test_cuda_instance_columns_match_planner():
    """The kernels' instance-table columns (KI_*) are the planner's."""
    from ezpz_tpu_torch.ops import fleet_plan

    src = open(os.path.join(ROOT, "ezpz_tpu_torch", "csrc", "fleet_common.cuh")).read()
    cols = dict(re.findall(r"\b(KI_[A-Z]+) = (\d+)", src))
    for name in ("KI_KIND", "KI_DIM", "KI_NV", "KI_POFF", "KI_WORD", "KI_BIT",
                 "KI_PK", "KI_IDS", "KI_SLOTS", "KI_COLS"):
        assert int(cols[name]) == getattr(fleet_plan, name), name


def test_port_imports_no_jax():
    """``import ezpz_tpu_torch`` (and every module of the port, the native
    extensions loaded) loads neither jax nor the JAX package."""
    code = (
        "import sys\n"
        "import ezpz_tpu_torch, ezpz_tpu_torch.batch, ezpz_tpu_torch.textual\n"
        "import ezpz_tpu_torch.models.blocks, ezpz_tpu_torch.ops.fused_fleet\n"
        "import ezpz_tpu_torch.ops._build, ezpz_tpu_torch.ops.fleet_plan\n"
        "import ezpz_tpu_torch.solver, ezpz_tpu_torch.ops.linalg\n"
        "import ezpz_tpu_torch.ops.coarse_fleet\n"
        "import ezpz_tpu_torch.api, ezpz_tpu_torch.dof, ezpz_tpu_torch.outcomes\n"
        "import ezpz_tpu_torch.cli, ezpz_tpu_torch.viz, ezpz_tpu_torch.utils.warnings\n"
        "import ezpz_tpu_torch.serve, ezpz_tpu_torch.embed, ezpz_tpu_torch.native\n"
        "import ezpz_tpu_torch.parallel, ezpz_tpu_torch.ops.banded\n"
        "import ezpz_tpu_torch.ops.banded_spd, ezpz_tpu_torch.benches.coupled_bench\n"
        "import ezpz_tpu_torch.parallel.fleet, ezpz_tpu_torch.fixtures\n"
        "import ezpz_tpu_torch.residual_viz, ezpz_tpu_torch.utils.debug\n"
        "import ezpz_tpu_torch.examples.basic, ezpz_tpu_torch.examples.parser\n"
        "import ezpz_tpu_torch.examples.scale\n"
        "import ezpz_tpu_torch.parallel.dist, ezpz_tpu_torch.parallel.schur\n"
        "import ezpz_tpu_torch.parallel.hier, ezpz_tpu_torch.launch\n"
        "import ezpz_tpu_torch.dryrun, ezpz_tpu_torch.checkpoint\n"
        "ezpz_tpu_torch.native.load_fastparse(), ezpz_tpu_torch.native.load_fastdecomp()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'ezpz_tpu.'))"
        " or m == 'ezpz_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
