"""The banded SPD solve's CUDA kernel and its binding.

Replaces the row-per-step ``lax.scan`` passes of
``ezpz_tpu.ops.banded.banded_cholesky`` and ``banded_solve``: one launch
(``csrc/banded_spd.cu``) factors, forward- and back-substitutes B banded
systems, one thread per lane. Its plain version is
``ops.banded.banded_spd_reference``, and ``ops.banded.banded_spd_solve``
dispatches between the two by device.

The kernel reads lane-fastest buffers, (row, band entry, lane): the wrapper
transposes the (B, n, bw+1) band and the right-hand sides into that layout
and the solution back, allocates the factor's scratch, launches on the
current stream and raises on a refused launch. Bands up to
``_build.BANDED_CAPACITIES[-1]`` (32) wide run; a wider one raises
``NotImplementedError``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import debug
from . import _build

# Kernel launches made by ``banded_spd_cuda`` in this process.
LAUNCHES = 0


def banded_spd_cuda(Ab: torch.Tensor, b: torch.Tensor):
    """The kernel on CUDA ``Ab`` (B, n, bw+1) and ``b`` (B, n) or (B, n, m),
    both float32 or both float64: returns ``(x, fail (B,) bool)`` as
    ``ops.banded.banded_spd_reference`` does. Raises when the inputs are
    not on a CUDA device, the band is wider than the kernel's largest
    capacity, ``nvcc`` or the build fails, or the launch is refused."""
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
    if bw > _build.BANDED_CAPACITIES[-1]:
        raise NotImplementedError(f"half-bandwidth {bw} exceeds the banded kernel's "
                                  f"largest capacity {_build.BANDED_CAPACITIES[-1]}")
    m = 1 if b.dim() == 2 else b.shape[2]
    fail = torch.zeros((B,), dtype=torch.bool, device=Ab.device)
    if B == 0 or n == 0 or m == 0:
        return torch.zeros_like(b), fail
    ab_t = Ab.permute(1, 2, 0).contiguous()
    rhs_t = b.reshape(B, n, m).permute(1, 2, 0).contiguous()
    lb_t = torch.empty_like(ab_t)
    x_t = torch.empty_like(rhs_t)
    lib = _build.load_library()
    with torch.cuda.device(Ab.device):
        stream = torch.cuda.current_stream(Ab.device).cuda_stream
        err = lib.ezpz_banded_spd(int(Ab.dtype == torch.float64), ab_t.data_ptr(),
                                  rhs_t.data_ptr(), lb_t.data_ptr(), x_t.data_ptr(),
                                  fail.data_ptr(), B, n, bw, m, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"banded_spd kernel launch failed: cudaError {err} "
                           f"({_build.error_string(lib, err)})")
    _build.count_launches(__name__, 1)
    debug.check_outputs("the banded_spd kernel", x_t)
    return x_t.permute(2, 0, 1).reshape(b.shape), fail
