"""The traced run: ``torch.profiler`` (CPU and CUDA) around a fixed count
of steady iterations, its Chrome trace read back into one summary that
the per-layer readers (``metrics/<name>.py``) take their numbers from.

The summary holds the window (the ``portbench.window`` annotation), the
device's busy time inside it (the union of its kernels, copies and sets),
every device operation by name, the largest device operations and the
longest idle gaps named by the host operation running in them, and the
loop's own count of the work (``work``).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "portbench.window"
NAMED_GAPS = 1000
# A name in the breakdown keeps this many characters: enough to tell
# PyTorch's templated kernels apart.
NAME_CHARS = 160


def trace_path() -> Path:
    """Where the trace is written: a fixed name under ``TMPDIR``."""
    base = Path(os.environ.get("TMPDIR") or "/tmp") / "portbench"
    base.mkdir(parents=True, exist_ok=True)
    return base / "trace.json"


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events, iterations: int) -> dict:
    """The summary of a Chrome trace's ``traceEvents`` over ``iterations``
    steady iterations (times in seconds)."""
    spans = [e for e in events if e.get("ph") == "X"]
    window = [e for e in spans if e.get("name") == WINDOW and e.get("cat") in HOST_CATS]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW} annotation")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    device = [e for e in spans if e.get("cat") in DEVICE_CATS
              and w0 <= float(e["ts"]) <= w1]
    ops = defaultdict(lambda: [0, 0.0, ""])
    for e in device:
        ops[e["name"]][0] += 1
        ops[e["name"]][1] += float(e["dur"]) / 1e6
        ops[e["name"]][2] = e["cat"]
    busy = _merged((max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
                   for e in device)
    busy_s = sum(b - a for a, b in busy) / 1e6
    return {
        "iterations": iterations,
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_s,
        "device_ops": {k: {"count": c, "seconds": s, "cat": cat}
                       for k, (c, s, cat) in ops.items()},
        "kernels": sum(1 for e in device if e["cat"] == "kernel"),
        "breakdown": {
            "device_ops": sorted(([k[:NAME_CHARS], s] for k, (_c, s, _cat) in ops.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": _idle_gaps(spans, busy, w0, w1),
        },
    }


def _idle_gaps(spans, busy, w0, w1):
    """The idle gaps inside the window, the ``NAMED_GAPS`` longest named by
    the innermost host operation running at their middle, summed by name:
    the ten largest sums."""
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a),
                  reverse=True)[:NAMED_GAPS]
    host = sorted((float(e["ts"]), -float(e["dur"]), e["name"])
                  for e in spans if e.get("cat") in HOST_CATS and e.get("name") != WINDOW)
    by_name = defaultdict(float)
    # One sweep: host operations nest, so the open ones form a stack whose
    # top is the innermost running at a point.
    stack, i = [], 0
    for length, a, b in sorted(gaps, key=lambda g: g[1] + g[2]):
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            start, neg_dur, name = host[i]
            while stack and stack[-1][0] < start:
                stack.pop()
            stack.append((start - neg_dur, name))
            i += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        by_name[stack[-1][1] if stack else "host outside any operation"] += length / 1e6
    return sorted(([k[:NAME_CHARS], v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:10]


def read_trace(path: Path) -> list:
    with open(path) as fh:
        return json.load(fh)["traceEvents"]
