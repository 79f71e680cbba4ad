"""Build the CUDA sources in ``csrc/`` with ``nvcc`` at first use and bind
them with ``ctypes``.

The library has a plain C interface (no PyTorch headers), so ``nvcc``
builds it in seconds: one ``nvcc -c`` per source, all started together,
then one link. It lands in ``build/ezpz_tpu_torch/`` under the repository
root, named by a hash of the sources and flags: a rebuilt checkout with
unchanged sources reuses it, and any edit rebuilds. The compiler's output
(``-Xptxas -v``: registers, local memory, spills per instantiation) is kept
beside the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("fused_fleet.cu", "coarse_fleet.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ezpz_tpu_torch"

# IEEE division and sqrt and no FMA contraction keep the kernels' f32
# phase comparable with the plain versions operation for operation.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "--fmad=false", "-std=c++17",
    "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
)

# (max variables, max residual rows) of each compiled instantiation of the
# kernels, smallest first. Mirrors CAPS in csrc/fleet_common.cuh.
CAPACITIES = ((4, 8), (16, 32), (64, 256))


def capacity_for(plan) -> tuple:
    """The smallest compiled capacity that holds ``plan`` (variables,
    residual rows; instances and constraints count against the rows).
    Raises ``NotImplementedError`` above the largest."""
    need_rows = max(plan.n_rows, plan.n_inst, plan.n_constraints)
    for n_max, rows_max in CAPACITIES:
        if plan.n_vars <= n_max and need_rows <= rows_max:
            return n_max, rows_max
    n_max, rows_max = CAPACITIES[-1]
    raise NotImplementedError(
        f"topology with {plan.n_vars} variables and {need_rows} residual "
        f"rows exceeds the fleet kernels' largest capacity ({n_max} "
        f"variables, {rows_max} rows)")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the fleet CUDA kernels cannot be built")


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
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)],
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
    lib.ezpz_fused_fleet.restype = i
    lib.ezpz_fused_fleet.argtypes = [
        i, i,                      # capacity (n_max, rows_max)
        p, p, i, i, i, i, i,       # x0, par, B, n, rows, n_cons, P
        p, i, p, p, p, p, p,       # inst, n_inst, w32, w64, perm, inv, nzl
        i, i, i,                   # coarse_trips, refine_trips, max_iterations
        f, f, f, d, f, f, f,       # ctol, cstol, stol, rtol, lam0, decr, incr
        p, p, p, p, p,             # x, iterations, converged, sat, deg
        p,                         # stream
    ]
    lib.ezpz_coarse_fleet.restype = i
    lib.ezpz_coarse_fleet.argtypes = [
        i, i,                      # capacity (n_max, rows_max)
        p, p, i, i, i, i, i,       # x0, par, B, n, rows, n_cons, P
        p, i, p, p, p, p, p,       # inst, n_inst, w32, w64, perm, inv, nzl
        i,                         # trips
        f, f, f, f, f,             # ctol, cstol, lam0, decr, incr
        p, p, p, p,                # x, iterations, converged, deg
        p,                         # stream
    ]
    lib.ezpz_fused_fleet_capacity.restype = i
    lib.ezpz_fused_fleet_capacity.argtypes = [i, ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.ezpz_cuda_error_string.restype = ctypes.c_char_p
    lib.ezpz_cuda_error_string.argtypes = [i]
    if compiled_capacities(lib) != CAPACITIES:
        raise RuntimeError(f"library capacities {compiled_capacities(lib)} != "
                           f"{CAPACITIES}")
    return lib


def compiled_capacities(lib) -> tuple:
    """The (n_max, rows_max) instantiations the library reports."""
    out = []
    n_max, rows_max = ctypes.c_int(), ctypes.c_int()
    k = 0
    while lib.ezpz_fused_fleet_capacity(k, ctypes.byref(n_max),
                                        ctypes.byref(rows_max)) == 0:
        out.append((n_max.value, rows_max.value))
        k += 1
    return tuple(out)


def error_string(lib, err: int) -> str:
    return lib.ezpz_cuda_error_string(err).decode()
