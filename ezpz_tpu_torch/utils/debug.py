"""The NaN/Inf switches: ``EZPZ_TPU_DEBUG_NANS=1`` and ``EZPZ_TPU_DEBUG_INFS=1``.

The counterpart of the JAX package's ``jax_debug_nans`` / ``jax_debug_infs``
hooks (``ezpz_tpu/__init__.py:42-45``), the numerical sanitizer: with a
switch armed, the first torch operation whose floating output holds a NaN
(an Inf) raises ``FloatingPointError`` naming the operation, instead of
letting the value flow on into a rejected LM step. ``ezpz_tpu_torch``
reads both variables once, when it is imported (``arm_from_env``).

Off by default: the solver's hot path uses NaN on a non-SPD factorization
as its failure signal, so an armed switch is for finding the kernel at
fault, not for production.

PyTorch idiom: a ``TorchDispatchMode`` sees every operation that reaches
the dispatcher and checks its outputs. Dispatch modes are per thread: the
mode is entered on the thread that imports the package, and the port's own
worker threads enter it too (``armed_in_thread``). The CUDA kernels bound
with ctypes bypass the dispatcher, so their wrappers check their outputs
with ``check_outputs``.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# What the switches check: {"nan", "inf"}, empty when off.
_CHECKS: frozenset = frozenset()
_THREAD = threading.local()

# Allocations whose contents are not a result: uninitialised memory may
# hold any bit pattern.
_UNINITIALISED = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "resize_"}


def _bad(t: torch.Tensor) -> str:
    """"NaN" or "Inf" when ``t`` holds one the switches check, else ""."""
    if (not (t.is_floating_point() or t.is_complex()) or t.numel() == 0
            or t._is_zerotensor() or t.is_meta):
        # A zero tensor (torch.func's known-zero tangents) has no storage.
        return ""
    if "nan" in _CHECKS and bool(torch.isnan(t).any()):
        return "NaN"
    if "inf" in _CHECKS and bool(torch.isinf(t).any()):
        return "Inf"
    return ""


def check_outputs(name: str, *outputs) -> None:
    """Raise ``FloatingPointError`` when an armed switch finds a NaN (Inf)
    in one of ``outputs`` (tensors; others are skipped). ``name`` is the
    operation's, for the message. Does nothing when both switches are
    off."""
    if not _CHECKS:
        return
    for t in outputs:
        if isinstance(t, torch.Tensor):
            what = _bad(t)
            if what:
                raise FloatingPointError(f"{what} produced by {name}")


class FloatCheckMode(TorchDispatchMode):
    """Checks the floating outputs of every dispatched operation."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALISED:
            check_outputs(str(func), *(out if isinstance(out, (tuple, list)) else (out,)))
        return out


def arm(nans: bool, infs: bool) -> None:
    """Arm the switches (process-wide) and enter the checking mode on this
    thread."""
    global _CHECKS
    _CHECKS = frozenset(k for k, on in (("nan", nans), ("inf", infs)) if on)
    if _CHECKS and not getattr(_THREAD, "mode", None):
        _THREAD.mode = FloatCheckMode()
        _THREAD.mode.__enter__()


def arm_from_env() -> None:
    """Arm from ``EZPZ_TPU_DEBUG_NANS`` / ``EZPZ_TPU_DEBUG_INFS`` (any value
    but "" and "0" arms)."""
    def on(name):
        return os.environ.get(name, "") not in ("", "0")

    if on("EZPZ_TPU_DEBUG_NANS") or on("EZPZ_TPU_DEBUG_INFS"):
        arm(on("EZPZ_TPU_DEBUG_NANS"), on("EZPZ_TPU_DEBUG_INFS"))


@contextlib.contextmanager
def armed_in_thread():
    """Inside: the checking mode is active on this thread when a switch is
    armed (for worker threads; a no-op where it already is, or when
    off)."""
    if not _CHECKS or getattr(_THREAD, "mode", None):
        yield
        return
    _THREAD.mode = FloatCheckMode()
    try:
        with _THREAD.mode:
            yield
    finally:
        _THREAD.mode = None
