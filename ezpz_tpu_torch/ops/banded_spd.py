"""The banded SPD solve's CUDA kernels and their binding.

Replaces the row-per-step ``lax.scan`` passes of
``ezpz_tpu.ops.banded.banded_cholesky`` and ``banded_solve``: one launch
(``csrc/banded_spd.cu``, ``csrc/banded_dynamic.cu``) factors, forward- and
back-substitutes B banded systems, one warp per lane. Its plain version is
``ops.banded.banded_spd_reference``, and ``ops.banded.banded_spd_solve``
dispatches between the two by device.

Every half-bandwidth runs, by one of four kernels that ``route_for``
names from (B, bw, itemsize). Bands up to ``_build.BANDED_CAPACITIES[-1]``
(32) take the warp kernel, which reads the callers' (B, n, bw+1) band and
(B, n, m) right-hand sides as they are, or from ``LANES_MIN_BATCH`` lanes
on the one-thread-per-lane kernel, which reads lane-fastest buffers,
(row, band entry, lane), into which the wrapper transposes. Wider bands
take the dynamic-width kernel (the warp kernel's design with the width a
run-time argument and the window in dynamic shared memory) up to
``_build.banded_dyn_max_bw(itemsize)`` (237 in f32, 166 in f64), and any
band past that the general-width kernel (window and running sums in
device memory). The wrapper allocates the factor's scratch (and the
general kernel's running sums), launches on the current stream and raises
on a refused launch.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import debug
from . import _build

# Kernel launches made by ``banded_spd_cuda`` in this process, by route
# (``route_for``); their sum is every launch.
LAUNCHES = {"warp": 0, "lanes": 0, "dynamic": 0, "general": 0}


# Batches of at least this many lanes take the one-thread-per-lane kernel.
# The crossover measured on one NVIDIA H100 80GB HBM3 at 700 W (n = 952,
# bw = 11, benches/banded_points.py): in f32 the warp kernel is faster up
# to 3,072 lanes and the two tie at 4,096; in f64 they tie at 3,072; from
# 4,096 lanes to 16,384 the lane kernel is faster (at 8,192: 3.4 against
# 5.2 ms in f32, 4.6 against 8.6 ms in f64).
LANES_MIN_BATCH = 4096


def route_for(B: int, bw: int, itemsize: int) -> str:
    """The kernel a batch of ``B`` lanes of half-bandwidth ``bw`` in
    ``itemsize``-byte floats takes: "lanes", "warp", "dynamic" or
    "general"."""
    if bw > _build.BANDED_CAPACITIES[-1]:
        return "dynamic" if bw <= _build.banded_dyn_max_bw(itemsize) else "general"
    return "lanes" if B >= LANES_MIN_BATCH else "warp"


def banded_spd_cuda(Ab: torch.Tensor, b: torch.Tensor):
    """The kernel on CUDA ``Ab`` (B, n, bw+1) and ``b`` (B, n) or (B, n, m),
    both float32 or both float64: returns ``(x, fail (B,) bool)`` as
    ``ops.banded.banded_spd_reference`` does, by the kernel
    ``route_for(B, bw, itemsize)`` names. Raises when the inputs are not on
    a CUDA device, ``nvcc`` or the build fails, or the launch is refused
    (the dynamic-width kernel's shared-memory attribute or occupancy query
    included)."""
    if Ab.device.type != "cuda" or b.device != Ab.device:
        raise ValueError(f"banded_spd_cuda takes CUDA tensors on one device, got "
                         f"{Ab.device} and {b.device}")
    if Ab.dtype not in (torch.float32, torch.float64) or b.dtype != Ab.dtype:
        raise ValueError(f"band and right-hand side must both be float32 or "
                         f"float64, got {Ab.dtype} and {b.dtype}")
    if Ab.dim() != 3 or b.dim() not in (2, 3) or b.shape[:2] != Ab.shape[:2]:
        raise ValueError(f"shapes {tuple(Ab.shape)} and {tuple(b.shape)} are not "
                         f"(B, n, bw+1) and (B, n[, m])")
    B, n, bwp1 = Ab.shape
    bw = bwp1 - 1
    m = 1 if b.dim() == 2 else b.shape[2]
    fail = torch.zeros((B,), dtype=torch.bool, device=Ab.device)
    if B == 0 or n == 0 or m == 0:
        return torch.zeros_like(b), fail
    route = route_for(B, bw, Ab.element_size())
    lanes = route == "lanes"
    if lanes:
        ab_k = Ab.permute(1, 2, 0).contiguous()
        rhs_k = b.reshape(B, n, m).permute(1, 2, 0).contiguous()
    else:
        ab_k, rhs_k = Ab.contiguous(), b.reshape(B, n, m).contiguous()
    lb_k = torch.empty_like(ab_k)
    x_k = torch.empty_like(rhs_k)
    f64 = int(Ab.dtype == torch.float64)
    lib = _build.load_library()
    with torch.cuda.device(Ab.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(Ab.device).cuda_stream)
        if route == "general":
            sums = torch.empty((B, bw), dtype=Ab.dtype, device=Ab.device)
            err = lib.ezpz_banded_spd_general(f64, ab_k.data_ptr(), rhs_k.data_ptr(),
                                              lb_k.data_ptr(), x_k.data_ptr(),
                                              sums.data_ptr(), fail.data_ptr(), B, n, bw,
                                              m, stream)
        elif route == "dynamic":
            err = lib.ezpz_banded_spd_dyn(f64, ab_k.data_ptr(), rhs_k.data_ptr(),
                                          lb_k.data_ptr(), x_k.data_ptr(), fail.data_ptr(), B,
                                          n, bw, m, stream)
        else:
            err = lib.ezpz_banded_spd(f64, int(lanes), ab_k.data_ptr(), rhs_k.data_ptr(),
                                      lb_k.data_ptr(), x_k.data_ptr(), fail.data_ptr(),
                                      B, n, bw, m, stream)
    if err != 0:
        raise RuntimeError(f"banded_spd kernel launch failed ({route}, bw={bw}): cudaError "
                           f"{err} ({_build.error_string(lib, err)})")
    _build.count_launches(__name__, 1, route)
    debug.check_outputs("the banded_spd kernel", x_k)
    if lanes:
        x_k = x_k.permute(2, 0, 1)
    return x_k.reshape(b.shape), fail
