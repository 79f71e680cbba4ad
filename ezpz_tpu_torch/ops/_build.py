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
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("fused_fleet.cu", "coarse_fleet.cu", "banded_spd.cu")
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

# Register capacities of the banded SPD kernel (CAPS in csrc/banded_spd.cu).
BANDED_CAPACITIES = (1, 2, 4, 8, 12, 16, 24, 32)

_LAUNCHES_LOCK = threading.Lock()


def count_launches(module: str, n: int) -> None:
    """Add ``n`` to the ``LAUNCHES`` counter of the wrapper module named
    ``module``. Under a lock: ``FleetSolver`` launches from one thread per
    card, and an unguarded read-add-store loses updates (the ctypes launch
    releases the interpreter lock)."""
    mod = sys.modules[module]
    with _LAUNCHES_LOCK:
        mod.LAUNCHES += n


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
    lib.ezpz_banded_capacity.restype = i
    lib.ezpz_banded_capacity.argtypes = [i]
    if compiled_shapes(lib) != SMALL_SHAPES:
        raise RuntimeError(f"library shapes {compiled_shapes(lib)} != {SMALL_SHAPES}")
    if banded_capacities(lib) != BANDED_CAPACITIES:
        raise RuntimeError(f"library band capacities {banded_capacities(lib)} != "
                           f"{BANDED_CAPACITIES}")
    return lib


def banded_capacities(lib) -> tuple:
    """The register capacities of the banded kernel the library reports."""
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
