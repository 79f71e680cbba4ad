"""Host data on a device: ``to_device`` makes and counts each copy, and
``on_device`` keeps a topology's static tables (indices, weights,
parameters, plans) on each device it meets, made at that device's first
call."""

from __future__ import annotations

import torch

from .. import tracing


def to_device(a, dtype=None, device=None) -> torch.Tensor:
    """``torch.as_tensor(a, dtype, device)``, counted as one host-to-device
    copy (``tracing``'s ``h2d.copies``) unless ``a`` is already a tensor.
    On the card such a copy from host memory waits for the stream to
    drain. Counted on every device, the CPU included."""
    if not isinstance(a, torch.Tensor):
        tracing.count("h2d.copies")
    return torch.as_tensor(a, dtype=dtype, device=device)


def copies(arrays):
    """A ``make`` for ``on_device``: ``arrays`` (host arrays or None) as
    tensors on a device, in order."""
    return lambda dev: tuple(None if a is None else to_device(a, device=dev) for a in arrays)


def on_device(cache: dict, dev, make):
    """What ``cache`` holds for the device ``dev``: ``make(dev)``, built at
    that device's first call. Threads that build at once keep the first
    stored copy (``setdefault``), so every caller reads the tables the
    cache holds."""
    dev = torch.device(dev)
    held = cache.get(dev)
    if held is None:
        held = cache.setdefault(dev, make(dev))
    return held
