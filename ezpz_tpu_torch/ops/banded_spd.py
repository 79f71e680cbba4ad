"""The banded SPD solve's CUDA kernels and their binding.

Replaces the row-per-step ``lax.scan`` passes of
``ezpz_tpu.ops.banded.banded_cholesky`` and ``banded_solve``: one launch
(``csrc/banded_spd.cu``, ``csrc/banded_lanes.cu``,
``csrc/banded_dynamic.cu``) factors, forward- and back-substitutes B
banded systems. Its plain version is ``ops.banded.banded_spd_reference``,
and ``ops.banded.banded_spd_solve`` dispatches between the two by device.

Every half-bandwidth runs, by one of four kernels that ``route_for``
names from (B, bw, itemsize); each reads the callers' (B, n, bw+1) band
and (B, n, m) right-hand sides as they are and writes x in their layout.
Bands up to ``_build.BANDED_CAPACITIES[-1]`` (32) take the warp kernel
(one warp a lane), or, up to bw 16 and from ``LANES_MIN_BATCH[capacity]``
lanes, the one-thread-per-lane kernel. Wider bands take the dynamic-width
kernel (the warp kernel's design with the width a run-time argument and
the window in dynamic shared memory) up to
``_build.banded_dyn_max_bw(itemsize)`` (237 in f32, 166 in f64), and any
band past that the general-width kernel (window and running sums in
device memory). The wrapper allocates the factor's scratch (and the
general kernel's running sums), launches on the current stream and raises
on a refused launch. The lane kernel also takes the LM step's damped solve
in one launch (``lam``; ``damps_in_one_launch`` says which bands): it adds
each lane's lambda to the diagonal as it loads the band, and in float32
re-solves only the lanes whose factor failed with the floored lambda of
``solver._rescued``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import debug
from . import _build

# Kernel launches made by ``banded_spd_cuda`` in this process, by route
# (``route_for``); their sum is every launch.
LAUNCHES = {"warp": 0, "lanes": 0, "dynamic": 0, "general": 0}


# Batches of at least LANES_MIN_BATCH[capacity] lanes take the
# one-thread-per-lane kernel at that capacity of
# ``_build.BANDED_LANES_CAPACITIES``, in f32 and f64 alike; smaller
# batches, and bands wider than 16, take the warp kernel. Read from the
# crossover sweep (``benches/banded_points.py --sweep crossover``: n = 952,
# bw = the capacity, B = 32 to 8,192; and B = 1 at bw 1, 4, 8, 16 and at
# bw = 11, n = 19,992) on one NVIDIA H100 80GB HBM3 at 700 W:
# - capacities 1-12: the lane kernel is faster at every batch measured, in
#   f32 and f64 (bw = 12: 1.05 against 1.17 ms at B = 32, 1.04 against
#   3.01 at 4,096 in f32; B = 1, n = 19,992, bw = 11: 17.7-18.0 against
#   20.9-21.2 ms f32, 23.4-23.6 against 31.8-32.0 f64). A batch below 32
#   lanes is one warp of either kernel, a lane's own chain.
# - capacity 16: the warp kernel is faster up to 1,024 lanes (1.35 against
#   1.62 ms f32, 2.09 against 2.38 f64; at B = 1 too), the lane kernel from
#   2,048 (1.62 against 1.75, 2.50 against 2.81).
# The lane kernel has no capacity above 16: there it was faster from 2,048
# to 4,096 lanes, but its instantiations spilled registers.
LANES_MIN_BATCH = {1: 1, 2: 1, 4: 1, 8: 1, 12: 1, 16: 2048}


def lanes_capacity(bw: int):
    """The lane kernel's capacity for a band of half-bandwidth ``bw``: the
    smallest of ``_build.BANDED_LANES_CAPACITIES`` that holds it, or
    None."""
    return next((cap for cap in _build.BANDED_LANES_CAPACITIES if cap >= bw), None)


def route_for(B: int, bw: int, itemsize: int) -> str:
    """The kernel a batch of ``B`` lanes of half-bandwidth ``bw`` in
    ``itemsize``-byte floats takes: "lanes", "warp", "dynamic" or
    "general"."""
    if bw > _build.BANDED_CAPACITIES[-1]:
        return "dynamic" if bw <= _build.banded_dyn_max_bw(itemsize) else "general"
    cap = lanes_capacity(bw)
    return "lanes" if cap is not None and B >= LANES_MIN_BATCH[cap] else "warp"


def damps_in_one_launch(Ab: torch.Tensor) -> bool:
    """Whether ``banded_spd_cuda`` takes a ``lam`` for the band ``Ab`` (B,
    n, bw+1): on a CUDA device, on the lane kernel's route."""
    B, _n, bwp1 = Ab.shape
    return Ab.device.type == "cuda" and route_for(B, bwp1 - 1, Ab.element_size()) == "lanes"


def banded_spd_cuda(Ab: torch.Tensor, b: torch.Tensor, lam: torch.Tensor = None):
    """The kernel on CUDA ``Ab`` (B, n, bw+1) and ``b`` (B, n) or (B, n, m),
    both float32 or both float64: returns ``(x, fail (B,) bool)`` as
    ``ops.banded.banded_spd_reference`` does, by the kernel
    ``route_for(B, bw, itemsize)`` names. Raises when the inputs are not on
    a CUDA device, ``nvcc`` or the build fails, or the launch is refused
    (the dynamic-width kernel's shared-memory attribute or occupancy query
    included).

    Given ``lam`` (B,) of the band's dtype, on the lane kernel's route
    alone (``damps_in_one_launch``), the band is solved with ``lam`` added
    to its diagonal column (``Ab`` is not written); in float32 a lane whose
    factor fails is solved again with ``max(lam, 1e-6 * max|diagonal|)``
    (the undamped diagonal): ``solver._rescued``'s answer in one launch."""
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
    if lam is not None and (lam.shape != (B,) or lam.dtype != Ab.dtype
                            or lam.device != Ab.device):
        raise ValueError(f"lam must be ({B},) {Ab.dtype} on {Ab.device}, got "
                         f"{tuple(lam.shape)} {lam.dtype} on {lam.device}")
    fail = torch.zeros((B,), dtype=torch.bool, device=Ab.device)
    if B == 0 or n == 0 or m == 0:
        return torch.zeros_like(b), fail
    route = route_for(B, bw, Ab.element_size())
    if lam is not None and not damps_in_one_launch(Ab):
        raise ValueError(f"a damped solve takes the lane kernel alone, not the {route} "
                         f"route (B={B}, bw={bw})")
    ab_k, rhs_k = Ab.contiguous(), b.reshape(B, n, m).contiguous()
    lam_k = None if lam is None else lam.contiguous()
    if route == "lanes":
        # The lane kernel's factor records: (n + bw, bw + 2, B rounded up
        # to 32), lane fastest.
        lb_k = torch.empty(((n + bw) * (bw + 2) * (-(-B // 32) * 32),), dtype=Ab.dtype,
                           device=Ab.device)
    else:
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
        elif route == "lanes":
            lam_p = None if lam_k is None else lam_k.data_ptr()
            err = lib.ezpz_banded_spd_lanes(f64, ab_k.data_ptr(), lam_p, rhs_k.data_ptr(),
                                            lb_k.data_ptr(), x_k.data_ptr(), fail.data_ptr(),
                                            B, n, bw, m, stream)
        else:
            err = lib.ezpz_banded_spd(f64, ab_k.data_ptr(), rhs_k.data_ptr(), lb_k.data_ptr(),
                                      x_k.data_ptr(), fail.data_ptr(), B, n, bw, m, stream)
    if err != 0:
        raise RuntimeError(f"banded_spd kernel launch failed ({route}, bw={bw}): cudaError "
                           f"{err} ({_build.error_string(lib, err)})")
    _build.count_launches(__name__, 1, route)
    debug.check_outputs("the banded_spd kernel", x_k)
    return x_k.reshape(b.shape), fail
