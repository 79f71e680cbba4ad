"""The batched LM loop's weighted Jacobian and its per-instance products:
CUDA kernel, binding and plain version.

``CompiledSystem.normal_equations`` sums JtJ and Jtr from per-instance
products by fixed gathers (``models/compiled._assembly``). This module
computes what those gathers read, for a batch of lanes ``x`` (B, n_vars)
of one float32 or float64 system: ``products(tables, x, pars, rhs)``
returns

* ``r`` (B, n_rows): the weighted residual rows, or the ``rhs`` rows when
  the caller gives them (the mixed refinement's f64 residual, cast);
* ``jj`` (B, n_jj + 1): ``dot(wjac[k], wjac[l])`` of every instance and
  pair (k, l) of its variables, column ``[block, (k, l), instance]``;
* ``jr`` (B, n_jr + 1): ``dot(wjac[k], wres)``, column ``[block, k,
  instance]``;
* ``deg`` (B, n_deg) int32: the degenerate flag of each instance of the
  blocks that can degenerate, in block order (``tables.cid`` names their
  constraints);

where ``wjac[k][d]`` is the weighted derivative of row d by the
instance's variable k. ``jj`` and ``jr`` end in a zero column, the one
that pads the gathers (``models.compiled.gather_sum_padded``).
``instance_table`` and ``product_columns`` own this numbering: the
assembly's plans read it from them, and the kernel's strides follow it.

Replaces no Pallas kernel: the JAX package leaves this step to ``jax.jvp``
under XLA. A CUDA ``x`` launches ``csrc/lm_jacobian.cu`` (one launch a
call, one thread per lane and instance; bound by the bytes it writes) or
raises; a CPU ``x`` takes ``products_reference``, the same arithmetic in
eager torch: one ``torch.func.jvp`` pass per instance variable, one op per
product.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..utils import debug
from . import _build
from .device_cache import to_device
from .kernels import KIND_ID, KernelSpec, jvp

# Kernel launches made by ``products`` in this process.
LAUNCHES = 0

# Instance table columns (IC_* in csrc/lm_jacobian.cu): kind, block, index
# in the block, the block's size, first JtJ and Jtr product columns, first
# residual row, degenerate flag column (-1: none), then the variable ids.
(IC_KIND, IC_BLOCK, IC_INDEX, IC_NB, IC_JJ, IC_JR, IC_ROW, IC_DEG) = range(8)
IC_IDS = 8
IC_COLS = 16
# Parameter blocks one launch takes (LMJ_MAX_BLOCKS); compile_system makes
# one block a kind, at most 23.
MAX_BLOCKS = 32


def instance_table(blocks) -> Tuple[np.ndarray, int, int, int]:
    """The kernel's instance table of ``blocks`` (``KindBlock``s, in
    order): ``(inst (n_inst, IC_COLS) int32, n_jj, n_jr, n_deg)``. Instance
    ``i`` of a block of ``nb`` instances writes its products from the
    columns ``inst[IC_JJ]`` and ``inst[IC_JR]`` on, ``nb`` apart
    (``product_columns``), its rows from ``inst[IC_ROW]``."""
    rows = []
    off_jj = off_jr = row = n_deg = 0
    for b, blk in enumerate(blocks):
        spec = blk.spec
        nb, nv = blk.idx.shape
        t = np.full((nb, IC_COLS), -1, dtype=np.int32)
        i = np.arange(nb)
        t[:, IC_KIND] = KIND_ID[spec.name]
        t[:, IC_BLOCK] = b
        t[:, IC_INDEX] = i
        t[:, IC_NB] = nb
        t[:, IC_JJ] = off_jj + i
        t[:, IC_JR] = off_jr + i
        t[:, IC_ROW] = row + i * spec.dim
        if spec.can_degenerate:
            t[:, IC_DEG] = n_deg + i
            n_deg += nb
        t[:, IC_IDS:IC_IDS + nv] = blk.idx
        rows.append(t)
        off_jj += nb * nv * nv
        off_jr += nb * nv
        row += nb * spec.dim
    inst = np.concatenate(rows) if rows else np.zeros((0, IC_COLS), np.int32)
    return inst, off_jj, off_jr, n_deg


def product_columns(inst: np.ndarray, nv: int) -> Tuple[np.ndarray, np.ndarray]:
    """Where the rows ``inst`` of one block of ``nv`` variables write:
    ``(jj (n, nv, nv), jr (n, nv))``, the JtJ column of each instance's
    product (k, l), ``inst[IC_JJ] + (k * nv + l) * nb``, and the Jtr column
    of its product k, ``inst[IC_JR] + k * nb``: [block, (k, l), instance]
    and [block, k, instance]."""
    k = np.arange(nv, dtype=np.int64)
    nb = inst[:, IC_NB].astype(np.int64)
    jj = (inst[:, IC_JJ, None, None] + (k[:, None] * nv + k[None, :])[None]
          * nb[:, None, None])
    return jj, inst[:, IC_JR, None] + k[None, :] * nb[:, None]


@dataclass(frozen=True)
class JacobianTables:
    """One system's tables on one device (``jacobian_tables``): the
    kernel's instance table and weights, the compile-time parameters, the
    degenerate blocks' constraint ids, and per block the views the plain
    version reads."""

    specs: Tuple[KernelSpec, ...]
    inst: torch.Tensor  # (n_inst, IC_COLS) int32
    weights: torch.Tensor  # (n_inst,) in the system's dtype
    cid: torch.Tensor  # (n_deg,) long
    idx: Tuple[torch.Tensor, ...]  # per block (nb, nv) long
    weight: Tuple[torch.Tensor, ...]  # per block (nb,) views of ``weights``
    par: Tuple[torch.Tensor, ...]  # per block (nb, np) compile-time parameters
    rows: Tuple[Tuple[int, int], ...]  # per block (first, end) residual row
    n_rows: int
    n_jj: int
    n_jr: int
    n_deg: int
    n_ids: int  # the variables the ids reach: largest id + 1


def jacobian_tables(blocks, dtype: torch.dtype, device) -> JacobianTables:
    """``blocks``' tables on ``device``: four host-to-device copies
    (``device_cache.to_device``). ``CompiledSystem.tables`` makes them once
    per system and device (``device_cache.on_device``)."""
    inst, n_jj, n_jr, n_deg = instance_table(blocks)
    dev_inst = to_device(inst, device=device)
    weights = to_device(np.concatenate([np.asarray(b.weight) for b in blocks] or [np.zeros(0)]),
                        dtype=dtype, device=device)
    pars = to_device(np.concatenate([np.asarray(b.par).reshape(-1) for b in blocks]
                                    or [np.zeros(0)]), dtype=dtype, device=device)
    cid = to_device(np.concatenate([b.cid for b in blocks if b.spec.can_degenerate]
                                   or [np.zeros(0, np.int64)]),
                    dtype=torch.long, device=device)
    ids = dev_inst[:, IC_IDS:].long()
    idx, weight, par, rows = [], [], [], []
    lo = p_off = row = 0
    for b in blocks:
        nb, nv = b.idx.shape
        n_par = nb * b.spec.nparams
        idx.append(ids[lo:lo + nb, :nv])
        weight.append(weights[lo:lo + nb])
        par.append(pars[p_off:p_off + n_par].view(nb, b.spec.nparams))
        rows.append((row, row + nb * b.spec.dim))
        lo += nb
        p_off += n_par
        row += nb * b.spec.dim
    return JacobianTables(
        specs=tuple(b.spec for b in blocks), inst=dev_inst, weights=weights, cid=cid,
        idx=tuple(idx), weight=tuple(weight), par=tuple(par), rows=tuple(rows),
        n_rows=row, n_jj=n_jj, n_jr=n_jr, n_deg=n_deg,
        n_ids=max((int(b.idx.max()) + 1 for b in blocks if b.idx.size), default=0))


def products(t: JacobianTables, x: torch.Tensor, pars=None,
             rhs: Optional[torch.Tensor] = None):
    """``(r, jj, jr, deg)`` (module docstring) at ``x`` (B, n_vars) in the
    tables' dtype (float32 or float64), with ``pars`` per block (B or 1,
    nb, np) or the compile-time ones, and ``rhs`` (B, n_rows) or None, in
    the same dtype. A CUDA ``x`` launches the kernel (built from
    ``csrc/lm_jacobian.cu`` at first use) or raises: when ``nvcc`` is
    missing, the build fails, an input is not in the tables' dtype on
    ``x``'s device, or the launch is refused. Only a CPU ``x`` takes
    ``products_reference``."""
    if x.device.type == "cpu":
        return products_reference(t, x, pars, rhs)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _products_cuda(t, x, pars, rhs)


@functools.lru_cache(maxsize=None)
def _library():
    """The kernels' library, its instance table layout checked against
    this module's."""
    lib = _build.load_library()
    cols, blocks = ctypes.c_int(), ctypes.c_int()
    lib.ezpz_lm_jacobian_layout(ctypes.byref(cols), ctypes.byref(blocks))
    if (cols.value, blocks.value) != (IC_COLS, MAX_BLOCKS):
        raise RuntimeError(f"library instance table ({cols.value} columns, {blocks.value} "
                           f"blocks) != ({IC_COLS}, {MAX_BLOCKS})")
    return lib


def _block_pars(p: torch.Tensor, B: int, spec: KernelSpec, nb: int, like: torch.Tensor):
    """One block's parameters as the kernel reads them: ``(tensor, lane
    stride)``, a (nb, np) table shared by every lane at stride 0."""
    if p.dtype != like.dtype or p.device != like.device:
        raise ValueError(f"parameters of {spec.name} must be "
                         f"{str(like.dtype).removeprefix('torch.')} on {like.device}, "
                         f"got {p.dtype} on {p.device}")
    p = p.expand(B, nb, spec.nparams)
    if B == 1 or p.stride(0) == 0:
        return p[0].contiguous(), 0
    return p.contiguous(), nb * spec.nparams


def _products_cuda(t: JacobianTables, x, pars, rhs):
    B = x.shape[0]
    dev = x.device
    dtype = t.weights.dtype
    n_inst = t.inst.shape[0]
    if (dtype not in (torch.float32, torch.float64) or x.dtype != dtype or x.dim() != 2
            or x.shape[1] < t.n_ids):
        raise ValueError(f"the Jacobian kernel takes a float32 or float64 system and x (B, "
                         f"n >= {t.n_ids}) of its dtype, got {dtype} tables and {x.dtype} x "
                         f"of shape {tuple(x.shape)}")
    if len(t.specs) > MAX_BLOCKS:
        raise ValueError(f"{len(t.specs)} kind blocks, the kernel takes {MAX_BLOCKS}")
    if rhs is not None and (rhs.dtype != dtype or rhs.device != dev
                            or tuple(rhs.shape) != (B, t.n_rows)):
        raise ValueError(f"rhs must be ({B}, {t.n_rows}) {dtype} on {dev}, got "
                         f"{tuple(rhs.shape)} {rhs.dtype} on {rhs.device}")
    x = x.contiguous()
    rhs = None if rhs is None else rhs.contiguous()
    r = rhs if rhs is not None else torch.empty((B, t.n_rows), dtype=dtype, device=dev)
    jj = torch.empty((B, t.n_jj + 1), dtype=dtype, device=dev)
    jr = torch.empty((B, t.n_jr + 1), dtype=dtype, device=dev)
    deg = torch.empty((B, t.n_deg), dtype=torch.int32, device=dev)
    if B * n_inst == 0:
        jj.zero_()
        jr.zero_()
        return r, jj, jr, deg
    # Held until the launch is queued: the kernel reads them.
    held = [_block_pars(t.par[b] if pars is None else pars[b], B, spec, t.idx[b].shape[0], x)
            for b, spec in enumerate(t.specs)]
    n = len(held)
    ptrs = (ctypes.c_void_p * max(n, 1))(*(p.data_ptr() for p, _s in held))
    strides = (ctypes.c_longlong * max(n, 1))(*(s for _p, s in held))
    lib = _library()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = lib.ezpz_lm_jacobian(
            int(dtype == torch.float64), t.inst.data_ptr(), t.weights.data_ptr(), n_inst, x.data_ptr(),
            x.shape[1], None if rhs is None else rhs.data_ptr(), t.n_rows, ptrs, strides, n,
            r.data_ptr(), jj.data_ptr(), t.n_jj, jr.data_ptr(), t.n_jr, deg.data_ptr(),
            t.n_deg, B, stream)
    if err != 0:
        raise RuntimeError(f"lm_jacobian kernel launch failed: cudaError {err} "
                           f"({_build.error_string(lib, err)})")
    _build.count_launches(__name__, 1)
    tracing.count("lm.jac_kernel")
    debug.check_outputs("the lm_jacobian kernel", r, jj, jr)
    return r, jj, jr, deg


# -- the plain version ---------------------------------------------------------


def products_reference(t: JacobianTables, x: torch.Tensor, pars=None,
                       rhs: Optional[torch.Tensor] = None):
    """The plain version of ``products`` on any device and dtype: per
    block, ``weighted_jacobian``'s passes, then each product as its own op
    (``dot``), concatenated in ``_assembly``'s numbering."""
    B = x.shape[0]
    rows, jj, jr, deg = [], [], [], []
    for i, spec in enumerate(t.specs):
        w = t.weight[i]
        p = t.par[i] if pars is None else pars[i]
        res, wjac, dg = weighted_jacobian(spec, x[:, t.idx[i]], p, w)
        if rhs is None:
            wres = [res[d] * w for d in range(spec.dim)]
        else:
            lo, hi = t.rows[i]
            r_b = rhs[:, lo:hi].reshape(B, -1, spec.dim)
            wres = [r_b[..., d] for d in range(spec.dim)]
        for ka in wjac:
            jr.append(dot(ka, wres))
            jj.extend(dot(ka, la) for la in wjac)
        rows.append(torch.stack(wres, dim=-1).reshape(B, -1))
        if spec.can_degenerate:
            deg.append(dg.to(torch.int32))
    zero = x.new_zeros((B, 1))
    r = torch.cat(rows, dim=1) if rows else x.new_zeros((B, 0))
    deg = (torch.cat(deg, dim=1) if deg
           else torch.zeros((B, 0), dtype=torch.int32, device=x.device))
    return r, torch.cat(jj + [zero], dim=1), torch.cat(jr + [zero], dim=1), deg


def weighted_jacobian(spec: KernelSpec, v: torch.Tensor, p: torch.Tensor, w: torch.Tensor):
    """One block at its gathered variables ``v`` (B, nb, nv) and parameters
    ``p`` (.., nb, np): ``(res (dim, B, nb), wjac, deg (B, nb))``, where
    ``wjac[a][d]`` (B, nb) is the derivative of row ``d`` by the instance's
    variable ``a`` times the weight ``w`` (nb,), by ``torch.func.jvp`` with
    one one-hot tangent per variable."""
    vs = tuple(v[..., k] for k in range(spec.nvars))
    ps = [p[..., k] for k in range(spec.nparams)]
    one, zero = torch.ones_like(vs[0]), torch.zeros_like(vs[0])
    wjac = []
    for a in range(spec.nvars):
        tangent = tuple(one if r == a else zero for r in range(spec.nvars))
        res, dres, deg = jvp(lambda *vv, fn=spec.fn: fn(vv, ps), vs, tangent)
        wjac.append([dres[d] * w for d in range(spec.dim)])
    return res, wjac, deg


def dot(a, b):
    """``a[0]*b[0] + a[1]*b[1] + ...`` over lists of tensors, in order."""
    acc = a[0] * b[0]
    for u, v in zip(a[1:], b[1:]):
        acc = acc + u * v
    return acc
