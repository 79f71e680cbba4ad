"""The port's banded SPD solve (``ezpz_tpu_torch.ops.banded``) against the
JAX package's ``ops/banded.py``, on the CPU.

Inputs come from numpy with a fixed seed: per lane a random symmetric band
made diagonally dominant (SPD), plus lanes that must fail: a negative
diagonal entry (the pivot goes negative) and, for bw >= 1, an exactly
singular pivot (a [[1, 1], [1, 1]] block: ``diag2`` is 0.0 exactly, as in
``tests/test_banded_tier.py``).

What must hold, and why:

* ``fail`` equal lane for lane, and failed lanes' ``x`` exactly zero;
* x within 1e-12 (f64) and 1e-5 (f32) relative: both packages run the
  same row recurrences in the same order; only the JAX package's
  ``jnp.sum`` of a row's squares and ``einsum`` of the forward step may
  be reassociated by XLA;
* ``dense_to_band`` equal exactly; ``plan_band`` equal to JAX's
  ``(perm, bw)`` (the same RCM code); ``make_banded_spd`` equal to the
  dense solve within 1e-10.

The CUDA kernel that a card's tensors reach is held against the plain
version in ``tests/test_torch_cuda.py``.
"""

import os
import re
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ezpz_tpu.constraints import Constraint as JConstraint
from ezpz_tpu.datatypes import DatumPoint as JPoint
from ezpz_tpu.models.compiled import compile_system as j_compile_system
from ezpz_tpu.ops import banded as JBd
from ezpz_tpu_torch.models.compiled import from_reference
from ezpz_tpu_torch.ops import banded as TBd
from ezpz_tpu_torch.ops import _build, banded_spd
from ezpz_tpu_torch.ops.linalg import spd_solve

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benches"))
from midsize_bench import rect_chain, rect_grid  # noqa: E402

B = 8


def _bands(n, bw, seed, singular=True):
    """(Ab (B, n, bw+1) lower bands, dense A (B, n, n), spd (B,) bool):
    lane 1 has a negative diagonal entry mid-matrix and, for bw >= 1 and
    n >= 3, lane 2 an exactly singular pivot at row 2."""
    rng = np.random.default_rng(seed)
    A = np.zeros((B, n, n))
    for k in range(B):
        for i in range(n):
            for j in range(max(0, i - bw), i):
                A[k, i, j] = A[k, j, i] = rng.uniform(-1.0, 1.0)
        A[k] += np.eye(n) * (2.0 * bw + 1.0 + rng.uniform(0.0, 1.0, n))
    spd = np.ones(B, dtype=bool)
    A[1, n // 2, n // 2] = -1.0
    spd[1] = False
    if singular and bw >= 1 and n >= 3:
        A[2] = np.eye(n)
        A[2, 1, 2] = A[2, 2, 1] = 1.0
        spd[2] = False
    Ab = np.stack([np.asarray(JBd.dense_to_band(jnp.asarray(a), bw)) for a in A])
    return Ab, A, spd


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("bw", [1, 3, 11])
@pytest.mark.parametrize("n", [5, 64])
def test_banded_spd_solve_matches_jax(n, bw, dtype):
    Ab, _A, spd = _bands(n, bw, seed=100 * bw + n + (dtype == "float32"))
    b = np.random.default_rng(n).uniform(-1.0, 1.0, (B, n))
    jx, jfail = jax.jit(jax.vmap(JBd.banded_spd_solve))(jnp.asarray(Ab, dtype),
                                                        jnp.asarray(b, dtype))
    tdt = getattr(torch, dtype)
    tx, tfail = TBd.banded_spd_solve(torch.as_tensor(Ab, dtype=tdt),
                                     torch.as_tensor(b, dtype=tdt))
    tx, tfail, jx = tx.numpy(), tfail.numpy(), np.asarray(jx)
    np.testing.assert_array_equal(tfail, np.asarray(jfail))
    np.testing.assert_array_equal(tfail, ~spd)
    assert (tx[tfail] == 0.0).all()
    rtol = 1e-12 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(tx[spd], jx[spd], rtol=rtol,
                               atol=rtol * np.abs(jx[spd]).max())


def test_banded_multi_rhs_matches_jax():
    """Several right-hand sides (B, n, m) solve against one factor."""
    Ab, _A, spd = _bands(40, 3, seed=7)
    b = np.random.default_rng(8).uniform(-1.0, 1.0, (B, 40, 3))
    jx, jfail = jax.jit(jax.vmap(JBd.banded_spd_solve))(jnp.asarray(Ab), jnp.asarray(b))
    tx, tfail = TBd.banded_spd_solve(torch.as_tensor(Ab), torch.as_tensor(b))
    np.testing.assert_array_equal(tfail.numpy(), np.asarray(jfail))
    np.testing.assert_allclose(tx.numpy()[spd], np.asarray(jx)[spd], rtol=1e-12, atol=1e-12)
    one, _ = TBd.banded_spd_solve(torch.as_tensor(Ab), torch.as_tensor(b[..., 1]))
    assert torch.equal(one, tx[..., 1])


def test_banded_solution_solves_the_dense_system():
    Ab, A, spd = _bands(30, 4, seed=3, singular=False)
    b = np.random.default_rng(4).normal(size=(B, 30))
    x, fail = TBd.banded_spd_solve(torch.as_tensor(Ab), torch.as_tensor(b))
    np.testing.assert_array_equal(fail.numpy(), ~spd)
    for k in np.flatnonzero(spd):
        np.testing.assert_allclose(x[k].numpy(), np.linalg.solve(A[k], b[k]), atol=1e-10)


def test_banded_exactly_singular_pivot_flags_failure():
    """The JAX package's boundary cases (``tests/test_banded_tier.py``):
    a 2x2 [[1,1],[1,1]] and a 4x4 whose third pivot cancels exactly."""
    A4 = np.eye(4)
    A4[1, 2] = A4[2, 1] = 1.0
    for A, b in ((np.ones((2, 2)), [1.0, 2.0]), (A4, np.ones(4))):
        Ab = JBd.dense_to_band(jnp.asarray(A), 1)
        jx, jfail = JBd.banded_spd_solve(Ab, jnp.asarray(b))
        tx, tfail = TBd.banded_spd_solve(torch.as_tensor(np.array(Ab))[None],
                                         torch.as_tensor(np.asarray(b))[None])
        assert bool(jfail) and bool(tfail[0])
        assert (tx == 0.0).all() and np.allclose(np.asarray(jx), 0.0)


@pytest.mark.parametrize("bw", [0, 2, 5])
def test_dense_to_band_matches_jax(bw):
    A = np.random.default_rng(bw).normal(size=(3, 9, 9))
    want = np.stack([np.asarray(JBd.dense_to_band(jnp.asarray(a), bw)) for a in A])
    got = TBd.dense_to_band(torch.as_tensor(A), bw).numpy()
    np.testing.assert_array_equal(got, want)


def _expander(n_vars=200, n_cons=250):
    rng = np.random.default_rng(0)
    cons = []
    for _ in range(n_cons):
        a, b = rng.choice(n_vars // 2, size=2, replace=False)
        cons.append(JConstraint.Distance(JPoint(int(2 * a), int(2 * a + 1)),
                                         JPoint(int(2 * b), int(2 * b + 1)), 1.0))
    return cons, np.zeros(n_vars)


def _port_system(jsys):
    return from_reference({
        "n_vars": jsys.n_vars, "n_constraints": jsys.n_constraints,
        "n_rows": jsys.n_rows,
        "blocks": [(b.spec.name, b.idx, b.par, b.weight, b.cid) for b in jsys.blocks],
    })


@pytest.mark.parametrize("topology", ["rect_chain(24)", "rect_grid(5,5)", "expander"])
def test_plan_band_matches_jax(topology):
    cons, x0 = {"rect_chain(24)": lambda: rect_chain(24),
                "rect_grid(5,5)": lambda: rect_grid(5, 5),
                "expander": _expander}[topology]()
    jsys = j_compile_system(cons, n_vars=len(x0))
    want = JBd.plan_band(jsys)
    got = TBd.plan_band(_port_system(jsys))
    if want is None:
        assert got is None
        return
    assert got[1] == want[1]
    if want[0] is None:
        assert got[0] is None
    else:
        np.testing.assert_array_equal(got[0], want[0])


def test_make_banded_spd_matches_dense_solve():
    """The planned band route (RCM permutation, band extraction, banded
    solve, permutation back) answers as the dense solve does."""
    cons, x0 = rect_chain(24)
    jsys = j_compile_system(cons, n_vars=len(x0))
    perm, bw = JBd.plan_band(jsys)
    n = len(x0)
    pattern = np.zeros((n, n), dtype=bool)
    for b in jsys.blocks:
        for ids in b.idx:
            pattern[np.ix_(ids, ids)] = True
    rng = np.random.default_rng(5)
    A = np.where(pattern, rng.uniform(-1.0, 1.0, (3, n, n)), 0.0)
    A = 0.5 * (A + A.transpose(0, 2, 1)) + np.eye(n) * n
    b = rng.normal(size=(3, n))
    x, fail = TBd.make_banded_spd(n, bw, perm)(torch.as_tensor(A), torch.as_tensor(b))
    want, wfail = spd_solve(torch.as_tensor(A), torch.as_tensor(b))
    assert not fail.any() and not wfail.any()
    np.testing.assert_allclose(x.numpy(), want.numpy(), atol=1e-10)


def test_cpu_band_takes_the_plain_version(monkeypatch):
    """A CPU band never reaches the CUDA wrapper; the plain version answers."""
    def no_kernel(*_a, **_k):
        raise AssertionError("the CUDA kernel must not run for CPU input")

    monkeypatch.setattr(banded_spd, "banded_spd_cuda", no_kernel)
    Ab, _A, _spd = _bands(6, 2, seed=1)
    x, fail = TBd.banded_spd_solve(torch.as_tensor(Ab), torch.ones((B, 6), dtype=torch.float64))
    want = TBd.banded_spd_reference(torch.as_tensor(Ab), torch.ones((B, 6), dtype=torch.float64))
    assert torch.equal(x, want[0]) and torch.equal(fail, want[1])


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        banded_spd.banded_spd_cuda(torch.zeros((1, 3, 2)), torch.zeros((1, 3)))


@pytest.mark.parametrize("cap", _build.BANDED_CAPACITIES)
@pytest.mark.parametrize("itemsize", [4, 8])
def test_banded_plan_fits_a_block(cap, itemsize):
    """Every capacity's warp kernel, in f32 and f64, holds its rings in one
    block's shared memory: within the H100's 227 KB, and within the 48 KB
    of static shared memory the kernel declares (beyond it the build would
    need the opt-in attribute), 4 lanes a block; and rows wide enough for
    the band and one right-hand-side value, at an odd stride minus one."""
    nbytes = _build.banded_smem_bytes(cap, itemsize)
    assert nbytes <= 232_448 and nbytes <= 48 * 1024
    assert _build.BANDED_WARPS == 4
    rows = cap + 1 + _build.BANDED_STAGE_ROWS
    stride = nbytes // (_build.BANDED_WARPS * rows * itemsize)
    assert stride * _build.BANDED_WARPS * rows * itemsize == nbytes
    assert stride >= cap + 2 and (stride - 1) % 2 == 1
    assert _build.banded_plan()[1][cap, itemsize] == nbytes


@pytest.mark.parametrize("cap", _build.BANDED_CAPACITIES)
@pytest.mark.parametrize("itemsize", [4, 8])
def test_banded_lanes_plan_fits_a_block(cap, itemsize):
    """The lane kernel's shared memory a block (one warp, 32 lanes), from
    first principles: the factor pass's window (cap slots of cap + 2
    values) and two stage buffers (each lane's 16-byte-aligned span of G
    rows of cap + 1 values, G = 8 in f32 and 4 in f64, an odd number of
    16-byte units, and the right-hand side at lane pitch 33), or the
    backward pass's ring of records (cap + 2 values) in groups of 4, as
    many groups (4 to 8) as the factor pass's buffers hold beside the
    doubled history (2 cap values). Every lane capacity fits the H100's
    227 KB. The warp kernel's capacities past 16 have no lane
    instantiation (they spilled), and their bands take the warp kernel at
    every batch."""
    if cap not in _build.BANDED_LANES_CAPACITIES:
        assert cap > 16 and banded_spd.lanes_capacity(cap) is None
        assert cap not in banded_spd.LANES_MIN_BATCH
        assert [banded_spd.route_for(B, cap, itemsize) for B in (1, 2048, 8192, 16384)] == \
            ["warp"] * 4
        return
    g = 4 if itemsize == 8 else 8
    span = -(-(g * (cap + 1) * itemsize + 15) // 16) * 16
    if (span // 16) % 2 == 0:
        span += 16
    stage = 32 * span + -(-(g * 33 * itemsize) // 16) * 16
    window = cap * (cap + 2) * 32 * itemsize
    factor = window + 2 * stage
    record, hist = (cap + 2) * 32 * itemsize, 2 * cap * 32 * itemsize
    groups = min(max((factor - hist) // record // 4, 4), 8)
    want = max(factor, 4 * groups * record + hist)
    assert _build.banded_lanes_ring(cap, itemsize) == 4 * groups
    assert _build.banded_lanes_smem_bytes(cap, itemsize) == want <= 232_448
    assert _build.banded_lanes_plan()[itemsize][cap] == want
    if (cap, itemsize) == (12, 4):  # phase 8l's band: 4 blocks an SM
        assert want == 51_264 and 4 * (want + 1024) <= 233_472


def test_banded_points_help():
    """The timing script's command line parses (``--help`` exits 0)."""
    import subprocess

    out = subprocess.run([sys.executable, "-m", "ezpz_tpu_torch.benches.banded_points",
                          "--help"], capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0 and "--points" in out.stdout


def test_banded_points_band_builder():
    """``make_band`` gives seeded, diagonally dominant SPD bands with zeros
    left of the first column, the layout ``dense_to_band`` gives."""
    from ezpz_tpu_torch.benches.banded_points import dense_of, make_band

    Ab, b = make_band(3, 9, 4, seed=2)
    Ab2, b2 = make_band(3, 9, 4, seed=2)
    assert torch.equal(Ab, Ab2) and torch.equal(b, b2)
    assert Ab.shape == (3, 9, 5) and b.shape == (3, 9) and Ab.dtype == torch.float64
    dense = dense_of(Ab)
    assert torch.equal(TBd.dense_to_band(dense, 4), Ab)
    assert torch.equal(dense, dense.transpose(1, 2))
    off = dense.abs().sum(-1) - dense.diagonal(dim1=1, dim2=2).abs()
    assert bool((dense.diagonal(dim1=1, dim2=2) > off).all())
    x, fail = TBd.banded_spd_reference(Ab, b)
    assert not fail.any()
    np.testing.assert_allclose(np.linalg.solve(dense.numpy(), b.numpy()[..., None])[..., 0], x.numpy(),
                               rtol=0, atol=1e-12)


def test_banded_points_cpu_point():
    """A tiny point through the plain version on the CPU: one record per
    dtype, with the H100 bound of ``chip_smoke.banded_bound_ms``'s formula."""
    from ezpz_tpu_torch.benches import banded_points

    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    recs = banded_points.main(["--cpu", "--points", "2:7:3", "--reps", "1"])
    assert [(r["B"], r["n"], r["bw"], r["dtype"], r["fails"]) for r in recs] == [
        (2, 7, 3, "float32", 0), (2, 7, 3, "float64", 0)]
    for rec, itemsize in zip(recs, (4, 8)):
        assert (rec["bound_ms"], rec["bound_by"]) == chip_smoke.banded_bound_ms(2, 7, 3, itemsize)
    for point in ((1024, 952, 11), (1, 19992, 11), (8192, 952, 11)):
        for itemsize in (4, 8):
            assert banded_points.bound_ms(*point, itemsize) == chip_smoke.banded_bound_ms(
                *point, itemsize)


def test_banded_route_by_batch():
    """Bands of a lane capacity up to 12 take the one-thread-per-lane
    kernel at every batch; capacity 16 from ``LANES_MIN_BATCH[16]``
    (2,048) lanes, the warp kernel below; bands of 17 to 32 the warp
    kernel at any batch (the lane kernel has no capacity there); wider
    bands the dynamic-width kernel at any batch (in f32 up to 237) and past
    it the general-width kernel."""
    cut = banded_spd.LANES_MIN_BATCH[16]
    assert cut == 2048
    batches = (1, 1024, cut - 1, cut, 4 * cut)
    routes = {bw: [banded_spd.route_for(B, bw, 4) for B in batches]
              for bw in (0, 11, 12, 13, 16, 17, 32, 33, 64, 65, 238)}
    assert routes == {0: ["lanes"] * 5, 11: ["lanes"] * 5, 12: ["lanes"] * 5,
                      13: ["warp"] * 3 + ["lanes"] * 2, 16: ["warp"] * 3 + ["lanes"] * 2,
                      17: ["warp"] * 5, 32: ["warp"] * 5, 33: ["dynamic"] * 5,
                      64: ["dynamic"] * 5, 65: ["dynamic"] * 5, 238: ["general"] * 5}
    assert _build.BANDED_CAPACITIES[-1] == 32


# (B, bw, route) at every edge of ``route_for``, per item size: the lane
# kernel at every batch up to bw 12, its crossover at capacity 16 (B 2047 /
# 2048 at bw 13 and 16), the warp kernel from bw 17 to 32 at any batch, the
# warp and lane kernels' width (32 / 33), the old edge of the warp kernel's
# capacities 48 and 64 (64 / 65), and the dynamic-width kernel's limit for
# the type and one past it.
ROUTE_EDGES = {
    4: [(1, 12, "lanes"), (8192, 12, "lanes"), (2047, 13, "warp"), (2048, 13, "lanes"),
        (2047, 16, "warp"), (2048, 16, "lanes"), (1, 17, "warp"), (8192, 17, "warp"),
        (8192, 32, "warp"), (1, 33, "dynamic"), (4096, 33, "dynamic"), (1, 64, "dynamic"),
        (4096, 65, "dynamic"), (1, 237, "dynamic"), (4096, 237, "dynamic"),
        (1, 238, "general"), (4096, 238, "general")],
    8: [(1, 12, "lanes"), (8192, 12, "lanes"), (2047, 13, "warp"), (2048, 13, "lanes"),
        (2047, 16, "warp"), (2048, 16, "lanes"), (1, 17, "warp"), (8192, 17, "warp"),
        (8192, 32, "warp"), (1, 33, "dynamic"), (4096, 33, "dynamic"), (1, 64, "dynamic"),
        (4096, 65, "dynamic"), (1, 166, "dynamic"), (4096, 166, "dynamic"),
        (1, 167, "general"), (4096, 167, "general")],
}


@pytest.mark.parametrize("itemsize", [4, 8])
def test_banded_route_edges(itemsize):
    """``route_for`` on both sides of each edge, in f32 and f64; the table
    names every lane capacity, the same in both types, and nothing past
    16 (bands of 17 to 32 take the warp kernel)."""
    assert banded_spd.LANES_MIN_BATCH == {1: 1, 2: 1, 4: 1, 8: 1, 12: 1, 16: 2048}
    assert tuple(banded_spd.LANES_MIN_BATCH) == _build.BANDED_LANES_CAPACITIES
    assert [banded_spd.lanes_capacity(bw) for bw in (0, 11, 13, 16, 17, 24, 32)] == \
        [1, 12, 16, 16, None, None, None]
    assert [(B, bw, banded_spd.route_for(B, bw, itemsize)) for B, bw, _r in
            ROUTE_EDGES[itemsize]] == ROUTE_EDGES[itemsize]


@pytest.mark.parametrize("itemsize,limit", [(4, 237), (8, 166)])
def test_banded_dyn_limit(itemsize, limit):
    """The dynamic-width kernel's widest band per type: its lane fits the
    232,448 B a block may use once the kernel opts in (the H100's 227 KB),
    the next band's does not, and a thread's slots at the limit are the
    kernel's most for the type (8 in f32, 6 in f64)."""
    assert _build.BANDED_DYN_BLOCK_SMEM == 232_448
    assert _build.banded_dyn_max_bw(itemsize) == limit
    assert _build.banded_dyn_lane_bytes(limit, itemsize) <= 232_448
    assert _build.banded_dyn_lane_bytes(limit + 1, itemsize) > 232_448
    assert -(-(limit + 1) // 32) == {4: 8, 8: 6}[itemsize]
    assert _build.banded_dyn_lanes(limit, itemsize) == 1
    assert _build.banded_dyn_lanes(limit + 1, itemsize) == 0


@pytest.mark.parametrize("bw", [32, 35, 48, 64, 65, 67, 100, 128, 166, 237])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_banded_dyn_plan_fits_a_block(bw, itemsize):
    """The dynamic-width kernel's ring: bw + 1 window rows and the staged
    rows, each at a stride of at least bw + 2 elements (a band row and one
    right-hand-side value) with stride - 1 odd (thread d's window read then
    hits a bank of its own); lanes a block those of 1 to 4 that keep the
    most lanes resident on an SM under the shared-memory model (blocks
    allocated in 128-byte units plus 1 KB reserved, of the SM's 228 KB),
    within the block's 232,448 B. At phase 8w's bw = 67: 20,160 B a lane
    in f32, 2 lanes a block, 10 lanes an SM (11 one-lane blocks would need
    11 x (20,224 + 1,024) B); 40,320 B in f64, 1 lane a block, 5 an SM."""
    stride = _build.banded_dyn_stride(bw)
    assert stride >= bw + 2 and (stride - 1) % 2 == 1 and stride - bw in (2, 3)
    lane = _build.banded_dyn_lane_bytes(bw, itemsize)
    assert lane == (bw + 1 + _build.BANDED_STAGE_ROWS) * stride * itemsize
    lanes = _build.banded_dyn_lanes(bw, itemsize)
    if bw > _build.banded_dyn_max_bw(itemsize):
        assert lanes == 0
        return
    assert 1 <= lanes <= 4 and lanes * lane <= 232_448
    block = _build.banded_dyn_block_smem(lanes, bw, itemsize)
    assert block % 128 == 1024 % 128 and lanes * lane + 1024 <= block < lanes * lane + 1152
    resident = {w: _build.banded_dyn_resident(w, bw, itemsize) for w in range(1, 5)}
    assert resident[lanes] == max(resident.values()) > 0
    assert all(resident[w] < resident[lanes] for w in range(lanes + 1, 5))
    assert resident[lanes] * block // lanes <= 233_472
    if bw == 67:
        assert (lane, lanes, resident[lanes]) == {4: (20_160, 2, 10), 8: (40_320, 1, 5)}[itemsize]


def test_banded_sources_match_build_module():
    """The banded kernels' constants in the CUDA sources are the build
    module's mirror: the capacities, lanes a block and staged rows
    (``banded_spd.cu``, ``banded_common.cuh``), the dynamic-width kernel's
    block limit and per-type widest bands (``banded_dynamic.cu``, whose
    static_assert holds them at compile time), and the lane kernel's
    capacities and plan constants (``banded_lanes.cu``); and the
    build compiles the three sources."""
    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "ezpz_tpu_torch", "csrc")
    read = lambda name: open(os.path.join(csrc, name)).read()  # noqa: E731
    caps = re.search(r"constexpr int CAPS\[\] = \{(.*?)\};", read("banded_spd.cu")).group(1)
    assert tuple(int(c) for c in caps.split(",")) == _build.BANDED_CAPACITIES
    common = read("banded_common.cuh")
    assert int(re.search(r"constexpr int WARPS = (\d+);", common).group(1)) == _build.BANDED_WARPS
    assert int(re.search(r"constexpr int STAGE = (\d+);", common).group(1)) == \
        _build.BANDED_STAGE_ROWS
    dyn = read("banded_dynamic.cu")
    assert int(re.search(r"constexpr int DYN_BLOCK_SMEM = (\d+);", dyn).group(1)) == \
        _build.BANDED_DYN_BLOCK_SMEM
    limits = re.search(r"static_assert\(dyn_max_bw<float>\(\) == (\d+) && "
                       r"dyn_max_bw<double>\(\) == (\d+)", dyn).groups()
    assert tuple(int(v) for v in limits) == (_build.banded_dyn_max_bw(4),
                                             _build.banded_dyn_max_bw(8))
    assert {"banded_spd.cu", "banded_dynamic.cu", "banded_lanes.cu"} <= set(_build.SOURCES)
    lanes = read("banded_lanes.cu")
    caps = re.search(r"constexpr int LANE_CAPS\[\] = \{(.*?)\};", lanes).group(1)
    assert tuple(int(c) for c in caps.split(",")) == _build.BANDED_LANES_CAPACITIES
    assert int(re.search(r"constexpr int PITCH = (\d+);", lanes).group(1)) == \
        _build.BANDED_LANES_PITCH
    assert int(re.search(r"static constexpr int GB = (\d+);", lanes).group(1)) == \
        _build.BANDED_LANES_GROUP
    assert int(re.search(r"constexpr int MAX_GROUPS = (\d+);", lanes).group(1)) == \
        _build.BANDED_LANES_GROUPS[1]
    # The warp kernel's source no longer holds a lane kernel.
    assert "lanes_kernel" not in read("banded_spd.cu")
