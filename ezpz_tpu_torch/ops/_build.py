"""Build the CUDA sources in ``csrc/`` with ``nvcc`` at first use and bind
them with ``ctypes``.

The library has a plain C interface (no PyTorch headers), so ``nvcc``
builds it in seconds: one ``nvcc -c`` per source, all started together,
then one link. It lands in ``build/ezpz_tpu_torch/`` under the repository
root, named by a hash of the sources and flags: a rebuilt checkout with
unchanged sources reuses it, and any edit rebuilds. The compiler's output
(``-Xptxas -v``: registers, local memory, spills per instantiation) is kept
beside the library as ``<name>.log``. Threads per block and the
occupancy bound are constants of the sources (``fleet_common.cuh``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from .. import tracing

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("fused_fleet.cu", "coarse_fleet.cu", "banded_spd.cu", "banded_dynamic.cu",
           "banded_lanes.cu", "lm_jacobian.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ezpz_tpu_torch"

# IEEE division and sqrt and no FMA contraction keep the kernels' f32
# phase comparable with the plain versions operation for operation.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "--fmad=false", "-std=c++17",
    "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
)

# (variables, instances) of each exact-shape instantiation of the kernels,
# whose lane state lives in registers, smallest first. Mirrors SMALL_SHAPES
# in csrc/fleet_common.cuh.
SMALL_SHAPES = ((1, 1), (2, 2), (4, 4), (8, 8))

# Capacities of the banded SPD warp kernel (CAPS in csrc/banded_spd.cu),
# its lanes (warps) per block (WARPS) and its band rows staged ahead
# (STAGE). Wider bands take the dynamic-width kernel up to its limit for
# the type (``banded_dyn_max_bw``), the general-width kernel above.
BANDED_CAPACITIES = (1, 2, 4, 8, 12, 16, 24, 32)
BANDED_WARPS = 4
BANDED_STAGE_ROWS = 4

def banded_smem_bytes(cap: int, itemsize: int) -> int:
    """Shared memory of one block of the banded warp kernel of capacity
    ``cap`` (row_stride and warp_elems in csrc/banded_spd.cu): per warp, a
    ring of cap + 1 factor rows and BANDED_STAGE_ROWS staged rows, each
    padded to a stride of cap + 2 (odd cap: cap + 3) elements."""
    stride = cap + 2 if cap % 2 == 0 else cap + 3
    return BANDED_WARPS * (cap + 1 + BANDED_STAGE_ROWS) * stride * itemsize


# Capacities of the one-thread-per-lane kernel, in f32 and f64 (LANE_CAPS
# in csrc/banded_lanes.cu): the ones ``ops/banded_spd.route_for`` sends
# there; wider bands take the warp kernel.
BANDED_LANES_CAPACITIES = (1, 2, 4, 8, 12, 16)
# Its shared-memory plan (LanePlan in csrc/banded_lanes.cu): the lane
# pitch of the staged right-hand side, the records a backward group
# brings, and the fewest and most groups in its ring.
BANDED_LANES_PITCH = 33
BANDED_LANES_GROUP = 4
BANDED_LANES_GROUPS = (4, 8)


def banded_lanes_stage_rows(cap: int, itemsize: int) -> int:
    """Band rows a stage group of the lane kernel (LanePlan::G): 8 in f32,
    4 in f64."""
    return 4 if itemsize == 8 else 8


def _lanes_factor_bytes(cap: int, itemsize: int) -> int:
    """The factor pass's buffers: the window (cap slots of cap + 2 values:
    entries 1..cap-1, diagonal, reciprocal, y) and two stage buffers (32
    lanes' 16-byte-aligned spans of G (cap + 1) values, each an odd number
    of 16-byte units, and the right-hand side at lane pitch 33), 32 lanes
    each."""
    r16 = lambda b: -(-b // 16) * 16  # noqa: E731
    g = banded_lanes_stage_rows(cap, itemsize)
    span = r16(g * (cap + 1) * itemsize + 15)
    lane_run = span if (span // 16) % 2 else span + 16
    stage = 32 * lane_run + r16(g * BANDED_LANES_PITCH * itemsize)
    return cap * (cap + 2) * 32 * itemsize + 2 * stage


def banded_lanes_ring(cap: int, itemsize: int) -> int:
    """Records in the lane kernel's backward ring (LanePlan::RS): groups of
    BANDED_LANES_GROUP records, as many as the factor pass's buffers hold
    beside the doubled history, within BANDED_LANES_GROUPS."""
    rec = (cap + 2) * 32 * itemsize
    hist = 2 * cap * 32 * itemsize
    fit = (_lanes_factor_bytes(cap, itemsize) - hist) // rec // BANDED_LANES_GROUP
    lo, hi = BANDED_LANES_GROUPS
    return BANDED_LANES_GROUP * min(max(fit, lo), hi)


def banded_lanes_smem_bytes(cap: int, itemsize: int) -> int:
    """Shared memory of one block (one warp, 32 lanes) of the lane kernel
    at capacity ``cap`` (LanePlan::BYTES): the larger of the factor pass's
    buffers and the backward pass's ring (``banded_lanes_ring`` records of
    cap + 2 values) with its doubled history (2 cap values), 32 lanes
    each."""
    solve = (banded_lanes_ring(cap, itemsize) * (cap + 2) + 2 * cap) * 32 * itemsize
    return max(_lanes_factor_bytes(cap, itemsize), solve)


# The dynamic-width banded kernel (banded_spd_dynamic_kernel): the shared
# memory a block may use once the kernel opts in (DYN_BLOCK_SMEM, the
# H100's 227 KB), the least half-bandwidth it takes (two slots a thread),
# and, for the lanes-a-block model below, the H100's shared memory per SM,
# the unit a block's shared memory is allocated in, and what each resident
# block reserves besides.
BANDED_DYN_BLOCK_SMEM = 232_448
BANDED_DYN_MIN_BW = 32
SM_SMEM_BYTES = 233_472
SMEM_ALLOC_UNIT = 128
BLOCK_RESERVED_SMEM = 1024


def banded_dyn_stride(bw: int) -> int:
    """Row stride of the dynamic-width kernel's ring in elements
    (dyn_stride): at least bw + 2, with stride - 1 odd."""
    return bw + 2 if bw % 2 == 0 else bw + 3


def banded_dyn_lane_bytes(bw: int, itemsize: int) -> int:
    """Shared memory of one lane of the dynamic-width kernel at ``bw``
    (dyn_lane_bytes): bw + 1 window rows and BANDED_STAGE_ROWS staged rows
    at ``banded_dyn_stride(bw)``."""
    return (bw + 1 + BANDED_STAGE_ROWS) * banded_dyn_stride(bw) * itemsize


@functools.lru_cache(maxsize=None)
def banded_dyn_max_bw(itemsize: int) -> int:
    """The widest band whose lane fits one block's BANDED_DYN_BLOCK_SMEM
    (dyn_max_bw): 237 in f32, 166 in f64."""
    bw = BANDED_DYN_MIN_BW
    while banded_dyn_lane_bytes(bw + 1, itemsize) <= BANDED_DYN_BLOCK_SMEM:
        bw += 1
    return bw


def banded_dyn_block_smem(lanes: int, bw: int, itemsize: int) -> int:
    """Shared memory an SM gives one block of ``lanes`` lanes of the
    dynamic-width kernel at ``bw``: the lanes' rings rounded up to
    SMEM_ALLOC_UNIT, and BLOCK_RESERVED_SMEM."""
    rings = lanes * banded_dyn_lane_bytes(bw, itemsize)
    return -(-rings // SMEM_ALLOC_UNIT) * SMEM_ALLOC_UNIT + BLOCK_RESERVED_SMEM


def banded_dyn_resident(lanes: int, bw: int, itemsize: int) -> int:
    """Lanes of the dynamic-width kernel at ``bw`` an SM holds at once in
    blocks of ``lanes`` where shared memory bounds it (at most 32 blocks
    and 64 warps); 0 when such a block does not fit."""
    if lanes * banded_dyn_lane_bytes(bw, itemsize) > BANDED_DYN_BLOCK_SMEM:
        return 0
    blocks = SM_SMEM_BYTES // banded_dyn_block_smem(lanes, bw, itemsize)
    return lanes * min(blocks, 32, 64 // lanes)


def banded_dyn_lanes(bw: int, itemsize: int) -> int:
    """Lanes a block of the dynamic-width kernel at ``bw``, as its launch
    picks them (dyn_lanes) where shared memory bounds the SM's blocks: of
    1 to BANDED_WARPS, the count that keeps the most lanes resident
    (``banded_dyn_resident``), the larger on a tie; 0 past the limit."""
    best, lanes = 0, 0
    for w in range(BANDED_WARPS, 0, -1):
        if banded_dyn_resident(w, bw, itemsize) > best:
            best, lanes = banded_dyn_resident(w, bw, itemsize), w
    return lanes


def count_launches(module: str, n: int, route: str = None) -> None:
    """Add ``n`` to the ``LAUNCHES`` counter of the wrapper module named
    ``module`` (to ``LAUNCHES[route]`` when the module counts by route).
    Under the counters' lock (``tracing.LOCK``): ``FleetSolver`` launches
    from one thread per card, and an unguarded read-add-store loses updates
    (the ctypes launch releases the interpreter lock)."""
    mod = sys.modules[module]
    with tracing.LOCK:
        if route is None:
            mod.LAUNCHES += n
        else:
            mod.LAUNCHES[route] += n


# Scratch of one big-topology launch; a larger batch is launched in chunks.
MAX_SCRATCH_BYTES = 1 << 30


def small_shape(plan):
    """The smallest exact-shape instantiation that holds an admitted
    ``plan`` (its variables and instances padded up), or None for the
    big-topology kernel: above the ladder, or when an instance names one
    variable twice (the register layout spreads each instance's Jacobian
    columns over distinct variables)."""
    if not plan.kernel["distinct_ids"]:
        return None
    for nv, ni in SMALL_SHAPES:
        if plan.n_vars <= nv and plan.n_inst <= ni:
            return nv, ni
    return None


def big_slots(plan, f64: bool) -> tuple:
    """(floats, doubles) of lane-interleaved scratch per lane of the
    big-topology kernel (BigSlots in csrc/fleet_common.cuh)."""
    n, m = plan.n_vars, 2 * plan.n_inst
    f32 = 4 * n + 2 * m + plan.fill
    return f32, plan.n_par + (2 * n + 2 * m if f64 else 0)


def chunks(B: int, per_lane_bytes: int):
    """(start, stop) of each big-topology launch of a batch of ``B``."""
    step = max(1, MAX_SCRATCH_BYTES // max(1, per_lane_bytes))
    return [(lo, min(B, lo + step)) for lo in range(0, B, step)]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for name in sorted(p.name for p in CSRC.iterdir()
                       if p.suffix in (".cu", ".cuh")):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libezpz_fleet_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. Raises
    ``RuntimeError`` with the compiler's output when ``nvcc`` fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    log = []
    try:
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [str(Path(tmp) / (Path(src).stem + ".o")) for src in SOURCES]
            # One compiler per source, all started together; then one link.
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                                       str(CSRC / src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
                     for src, obj in zip(SOURCES, objs)]
            outs = [proc.communicate()[0] for proc in procs]
            log += [" ".join(proc.args) + "\n" + out for proc, out in zip(procs, outs)]
            failed = [f"nvcc failed ({proc.returncode}):\n{out}"
                      for proc, out in zip(procs, outs) if proc.returncode != 0]
            if failed:
                raise RuntimeError("\n".join(failed))
            lib = str(Path(tmp) / so.name)
            link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                    "-o", lib, *objs]
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(lib, so)
    finally:
        Path(str(so) + ".log").write_text("\n".join(log))
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library, with its C
    signatures declared. Loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    p, i, f, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
    u64 = ctypes.c_ulonglong
    small = [i, i,                     # shape (variables, instances)
             p, p, i, i, i, i,         # x0, par, B, n, n_cons, P
             p, i, p, p, p, u64]       # host kinst, n_inst, w32, w64, perm; fill bits
    big = [p, p, i, i, i, i,           # x0, par, B, n, n_cons, P
           p, i, p, p, p,              # device kinst, n_inst, w32, w64, perm
           p, p, p, p, p, p, i,        # row_start, ent_col, cr_start, cr_pair, col_start, col_ent, fill
           p, p]                       # float and double scratch
    fused = [i, i, i,                  # coarse_trips, refine_trips, max_iterations
             f, f, f, d, f, f, f,      # ctol, cstol, stol, rtol, lam0, decr, incr
             p, p, p, p, p,            # x, iterations, converged, sat, deg
             p]                        # stream
    coarse = [i,                       # trips
              f, f, f, f, f,           # ctol, cstol, lam0, decr, incr
              p, p, p, p,              # x, iterations, converged, deg
              p]                       # stream
    for name, args in (("ezpz_fused_fleet_small", small + fused),
                       ("ezpz_fused_fleet_big", big + fused),
                       ("ezpz_coarse_fleet_small", small + coarse),
                       ("ezpz_coarse_fleet_big", big + coarse)):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = args
    for name in ("ezpz_fused_fleet_occupancy", "ezpz_coarse_fleet_occupancy"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.ezpz_small_shape.restype = i
    lib.ezpz_small_shape.argtypes = [i, ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.ezpz_cuda_error_string.restype = ctypes.c_char_p
    lib.ezpz_cuda_error_string.argtypes = [i]
    lib.ezpz_banded_spd.restype = i
    lib.ezpz_banded_spd.argtypes = [i, p, p, p, p, p,  # f64, band, rhs, factor, x, fail
                                    i, i, i, i, p]     # B, n, bw, m, stream
    lib.ezpz_banded_spd_lanes.restype = i
    lib.ezpz_banded_spd_lanes.argtypes = [i, p, p, p, p, p, p,  # f64, band, lam, rhs, factor, x,
                                          i, i, i, i, p]        # fail; B, n, bw, m, stream
    lib.ezpz_banded_lanes_capacity.restype = i
    lib.ezpz_banded_lanes_capacity.argtypes = [i]  # k
    lib.ezpz_banded_lanes_smem_bytes.restype = i
    lib.ezpz_banded_lanes_smem_bytes.argtypes = [i, i]  # capacity, f64
    lib.ezpz_banded_spd_dyn.restype = i
    lib.ezpz_banded_spd_dyn.argtypes = [i, p, p, p, p, p,  # f64, band, rhs, factor, x, fail
                                        i, i, i, i, p]     # B, n, bw, m, stream
    for name in ("ezpz_banded_dyn_lane_bytes", "ezpz_banded_dyn_lanes"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = [i, i]  # bw, f64
    lib.ezpz_banded_dyn_max_bw.restype = i
    lib.ezpz_banded_dyn_max_bw.argtypes = [i]
    lib.ezpz_banded_spd_general.restype = i
    lib.ezpz_banded_spd_general.argtypes = [i, p, p, p, p,  # f64, band, rhs, factor, x
                                            p, p,           # sums, fail
                                            i, i, i, i, p]  # B, n, bw, m, stream
    lib.ezpz_lm_jacobian.restype = i
    lib.ezpz_lm_jacobian.argtypes = [i, p, p, i,                 # f64, inst, w, n_inst
                                     p, i, p, i,                 # x, n_vars, rhs, n_rows
                                     ctypes.POINTER(p),          # host parameter pointers
                                     ctypes.POINTER(ctypes.c_longlong), i,  # their lane strides, n
                                     p, p, i, p, i, p, i,        # r, jj, n_jj, jr, n_jr, deg, n_deg
                                     i, p]                       # B, stream
    lib.ezpz_lm_jacobian_layout.restype = None
    lib.ezpz_lm_jacobian_layout.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.ezpz_banded_capacity.restype = i
    lib.ezpz_banded_capacity.argtypes = [i]
    lib.ezpz_banded_warps.restype = i
    lib.ezpz_banded_warps.argtypes = []
    lib.ezpz_banded_smem_bytes.restype = i
    lib.ezpz_banded_smem_bytes.argtypes = [i, i]
    if compiled_shapes(lib) != SMALL_SHAPES:
        raise RuntimeError(f"library shapes {compiled_shapes(lib)} != {SMALL_SHAPES}")
    if banded_capacities(lib) != BANDED_CAPACITIES:
        raise RuntimeError(f"library band capacities {banded_capacities(lib)} != "
                           f"{BANDED_CAPACITIES}")
    if banded_plan(lib) != banded_plan():
        raise RuntimeError(f"library banded plan {banded_plan(lib)} != {banded_plan()}")
    if banded_lanes_plan(lib) != banded_lanes_plan():
        raise RuntimeError(f"library lane-kernel plan {banded_lanes_plan(lib)} != "
                           f"{banded_lanes_plan()}")
    if banded_dyn_plan(lib) != banded_dyn_plan():
        raise RuntimeError(f"library dynamic-width plan {banded_dyn_plan(lib)} != "
                           f"{banded_dyn_plan()}")
    return lib


def banded_plan(lib=None) -> tuple:
    """(lanes per block, {(capacity, itemsize): shared bytes per block}) of
    the banded warp kernel: the library's report, or this module's mirror
    when ``lib`` is None."""
    if lib is None:
        return BANDED_WARPS, {(cap, size): banded_smem_bytes(cap, size)
                              for cap in BANDED_CAPACITIES for size in (4, 8)}
    return lib.ezpz_banded_warps(), {
        (cap, size): lib.ezpz_banded_smem_bytes(k, int(size == 8))
        for k, cap in enumerate(banded_capacities(lib)) for size in (4, 8)}


def banded_lanes_plan(lib=None) -> dict:
    """{itemsize: {capacity: shared bytes a block}} of the lane kernel:
    the library's report (its capacities and each one's plan), or this
    module's mirror when ``lib`` is None."""
    if lib is None:
        return {size: {cap: banded_lanes_smem_bytes(cap, size) for cap in BANDED_LANES_CAPACITIES}
                for size in (4, 8)}
    caps = []
    while (cap := lib.ezpz_banded_lanes_capacity(len(caps))) >= 0:
        caps.append(cap)
    return {size: {cap: lib.ezpz_banded_lanes_smem_bytes(cap, int(size == 8)) for cap in caps}
            for size in (4, 8)}


def banded_dyn_plan(lib=None) -> dict:
    """{itemsize: (widest band, {bw: bytes a lane})} of the dynamic-width
    kernel, at every width it takes and one past each end (-1 there): the
    library's report, or this module's mirror when ``lib`` is None."""
    out = {}
    for size in (4, 8):
        f64 = int(size == 8)
        top = banded_dyn_max_bw(size) if lib is None else lib.ezpz_banded_dyn_max_bw(f64)
        widths = range(BANDED_DYN_MIN_BW - 1, top + 2)
        if lib is None:
            lane = {bw: banded_dyn_lane_bytes(bw, size)
                    if BANDED_DYN_MIN_BW <= bw <= top else -1 for bw in widths}
        else:
            lane = {bw: lib.ezpz_banded_dyn_lane_bytes(bw, f64) for bw in widths}
        out[size] = (top, lane)
    return out


def banded_capacities(lib) -> tuple:
    """The capacities of the banded kernel the library reports."""
    out = []
    while (cap := lib.ezpz_banded_capacity(len(out))) >= 0:
        out.append(cap)
    return tuple(out)


def compiled_shapes(lib) -> tuple:
    """The (variables, instances) exact-shape instantiations the library
    reports."""
    out = []
    nv, ni = ctypes.c_int(), ctypes.c_int()
    k = 0
    while lib.ezpz_small_shape(k, ctypes.byref(nv), ctypes.byref(ni)) == 0:
        out.append((nv.value, ni.value))
        k += 1
    return tuple(out)


def resident_threads(lib, entry: str, shape, n_inst: int = 0) -> int:
    """Threads an SM holds at once for the ``entry`` (``"fused"``/
    ``"coarse"``) kernel of exact ``shape`` (variables, instances), or of
    the big-topology kernel for ``shape=None`` with the shared memory of
    ``n_inst`` instances."""
    threads = ctypes.c_int()
    nv, ni = shape if shape is not None else (0, 0)
    err = getattr(lib, f"ezpz_{entry}_fleet_occupancy")(nv, ni, n_inst,
                                                       ctypes.byref(threads))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: {error_string(lib, err)}")
    return threads.value


def error_string(lib, err: int) -> str:
    return lib.ezpz_cuda_error_string(err).decode()
