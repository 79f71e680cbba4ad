"""The port's native (C++) parser and union-find against its Python paths
and the JAX package's, on the CPU.

* ``ezpz_tpu_torch.native`` builds both extensions into
  ``build/ezpz_tpu_torch/native/`` and loads them under the port's module
  names, beside the JAX package's own copies in the same process.
* Every ``problem*.md`` of the corpus parses to the same ``Problem``
  through the port's native parser, the port's Python grammar and the
  JAX package's parser: instructions, labels, values, components and
  angles exactly equal.
* The bad inputs of ``tests/test_native_parser.py`` are rejected (the
  native module raises ``ValueError``; ``parse_problem`` raises
  ``ParseError`` on either path).
* The union-find cases of ``tests/test_native_decomp.py`` (random graphs,
  buffer dtypes, out-of-range ids, isolated constraints) run against the
  port, and its partitions equal the JAX package's Python union-find.
* ``build_buckets`` on ``massive_parallel_system`` gives equal buckets
  natively and with ``EZPZ_NO_NATIVE=1`` and the Python union-find.
"""

import glob
import os

import numpy as np
import pytest

from ezpz_tpu.models import blocks as JB
from ezpz_tpu.native import load_fastparse as j_load_fastparse
from ezpz_tpu.textual import parser as JPARSE
from ezpz_tpu_torch import native as TN
from ezpz_tpu_torch.models import blocks as TB
from ezpz_tpu_torch.textual import parser as TPARSE
from ezpz_tpu_torch.utils.errors import ParseError

from .helpers import CASES_DIR
from .test_torch_frontend import _instr_tuple, port_system

BAD_INPUTS = [
    "no header at all\n",
    "# constraints\nfrobnicate(p)\n\n# guesses\np roughly (0,0)\n",
    "# constraints\npoint p\n\n# guesses\np roughly nonsense\n",
    "# constraints\ndistance(a, b)\n\n# guesses\na roughly (0,0)\n",
]


@pytest.fixture(scope="module")
def fastparse():
    mod = TN.load_fastparse()
    if mod is None:
        pytest.skip("no C++ toolchain")
    return mod


@pytest.fixture(scope="module")
def fastdecomp():
    mod = TN.load_fastdecomp()
    if mod is None:
        pytest.skip("no C++ toolchain")
    return mod


def _problems():
    return sorted(glob.glob(os.path.join(CASES_DIR, "*", "problem*.md")))


def _problem_tuple(p):
    return ([_instr_tuple(i) for i in p.instructions], p.inner_points,
            p.inner_circles, p.inner_arcs, p.inner_lines,
            [(g.point, g.x, g.y) for g in p.point_guesses],
            [(g.scalar, g.guess) for g in p.scalar_guesses])


def test_extensions_build_under_the_port_and_beside_the_jax_ones(fastparse, fastdecomp):
    """The port's modules live in its build directory under its own names;
    the JAX package's copy loads in the same process and stays apart."""
    for mod, name in ((fastparse, "fastparse"), (fastdecomp, "fastdecomp")):
        assert mod.__name__ == f"ezpz_tpu_torch.native._{name}"
        assert os.path.dirname(mod.__file__) == str(TN.BUILD_DIR)
    jmod = j_load_fastparse()
    if jmod is not None:
        assert jmod is not fastparse and jmod.__name__ == "ezpz_tpu.native._fastparse"
        txt = open(os.path.join(CASES_DIR, "square", "problem.md")).read()
        assert jmod.parse(txt) == fastparse.parse(txt)


@pytest.mark.parametrize("path", _problems(),
                         ids=lambda p: os.path.relpath(p, CASES_DIR))
def test_native_matches_python_and_jax(path, fastparse):
    txt = open(path).read()
    native = _problem_tuple(TPARSE._problem_from_native(fastparse.parse(txt)))
    assert native == _problem_tuple(TPARSE.parse_problem(txt))
    assert native == _problem_tuple(TPARSE._parse_problem_py(txt))
    assert native == _problem_tuple(JPARSE.parse_problem(txt))


@pytest.mark.parametrize("bad", BAD_INPUTS)
def test_native_rejects_bad_input(bad, fastparse, monkeypatch):
    with pytest.raises(ValueError):
        fastparse.parse(bad)
    with pytest.raises(ParseError):
        TPARSE.parse_problem(bad)
    monkeypatch.setenv("EZPZ_NO_NATIVE", "1")
    with pytest.raises(ParseError):
        TPARSE.parse_problem(bad)


def _random_deps(rng, n_cons, n_vars):
    deps = []
    for _ in range(n_cons):
        k = int(rng.integers(0, 5))
        deps.append(sorted(set(int(v) for v in rng.integers(0, n_vars, k))))
    return deps


def test_native_matches_python_partition(fastdecomp):
    rng = np.random.default_rng(7)
    for trial in range(20):
        n_vars = int(rng.integers(1, 60))
        deps = _random_deps(rng, int(rng.integers(0, 40)), n_vars)
        native = TB._component_roots_native(deps, n_vars)
        # Root labels are canonical in all three.
        assert native == TB._component_roots_python(deps, n_vars), trial
        assert native == JB._component_roots_python(deps, n_vars), trial


@pytest.mark.parametrize("offsets_dtype, ids_dtype, raw", [
    (np.int64, np.int32, False),
    (np.int32, np.int64, False),
    (np.int32, np.float32, False),
    (np.int32, np.int32, True),  # raw bytes: buffer format 'B'
])
def test_native_rejects_wrong_dtype_buffers(fastdecomp, offsets_dtype, ids_dtype, raw):
    """int64 / float32 arrays and raw bytes must raise TypeError, never be
    silently reinterpreted as int32."""
    offsets = np.array([0, 1], offsets_dtype)
    ids = np.array([0], ids_dtype)
    with pytest.raises(TypeError):
        fastdecomp.components(4, offsets, ids.tobytes() if raw else ids)


def test_native_rejects_bad_ids(fastdecomp):
    offsets = np.array([0, 1], np.int32)
    ids = np.array([99], np.int32)  # out of range for n_vars=4
    with pytest.raises(ValueError):
        fastdecomp.components(4, offsets, ids)


@pytest.mark.parametrize("native", [True, False])
def test_empty_and_isolated_constraints(native, monkeypatch):
    from ezpz_tpu_torch.constraints import Constraint

    if not native:
        monkeypatch.setattr(TB, "_component_roots_native", lambda deps, n_vars: None)
    # Two isolated Fixed constraints and one shared pair.
    cs = [
        Constraint.Fixed(0, 1.0),
        Constraint.Fixed(3, 2.0),
        Constraint.ScalarEqual(1, 2),
    ]
    comps = TB.connected_components(cs, 4)
    assert len(comps) == 3
    assert [c.constraint_ids for c in comps] == [[0], [1], [2]]
    assert [c.var_ids for c in comps] == [[0], [3], [1, 2]]


def _buckets_tuple(buckets):
    out = []
    for b in buckets:
        out.append((
            [blk.spec.name for blk in b.system.blocks],
            [(blk.idx.tolist(), blk.par.tolist(), blk.weight.tolist(), blk.cid.tolist())
             for blk in b.system.blocks],
            [c.constraint_ids for c in b.components],
            b.var_index.tolist(), b.cid_index.tolist(),
            [np.asarray(p).tolist() for p in b.pars],
        ))
    return out


def test_build_buckets_equal_with_and_without_native(fastparse, fastdecomp, monkeypatch):
    """``massive_parallel_system`` (2,400 variables, 1,800 components):
    the native parser and union-find, then ``EZPZ_NO_NATIVE=1`` (Python
    parser) with the Python union-find, give the same buckets."""
    cons, x0 = port_system("massive_parallel_system")
    native = _buckets_tuple(TB.build_buckets(cons, len(x0)))
    monkeypatch.setenv("EZPZ_NO_NATIVE", "1")
    monkeypatch.setattr(TB, "_component_roots_native", lambda deps, n_vars: None)
    cons_py, x0_py = port_system("massive_parallel_system")
    np.testing.assert_array_equal(x0_py, x0)
    python = _buckets_tuple(TB.build_buckets(cons_py, len(x0_py)))
    assert len(native) == 2
    assert native == python
