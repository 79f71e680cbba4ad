#!/usr/bin/env python3
"""The program's own spans and counters in a traced run of a cell.

    python3 portbench/spans.py --workload chain64.fleet --seed 7

``ezpz_tpu_torch`` marks its layers with ``ezpz.*`` spans (``record_function``
while a profiler runs) and counts its host-to-device copies
(``tracing.counts()``). ``summarize`` reads the spans from the same Chrome
trace as ``trace.summarize``, over the same window (``trace.WINDOW``):

* per span name: how many opened in the window, their host seconds (total,
  and self: less their ``ezpz.*`` children), the device seconds of the
  kernels, copies and sets launched while it was the innermost ``ezpz.*``
  span open on the launching thread (matched through ``args.correlation``
  to their ``cuda_runtime`` or ``cuda_driver`` launch), and the device's
  idle seconds whose middle falls in it (``trace._idle_gaps``' rule);
* ``outside``: device and idle seconds under no ``ezpz.*`` span (the
  benchmark's own work, or a program without spans);
* ``unattributed``: device seconds with no launch event in the trace;
* ``solve_idle_s``: the idle seconds while the host was inside
  ``ezpz.batch.solve``;
* ``runtime``: the blocking runtime calls in the window (``RUNTIME_SHOWN``).

The harness's traced run (``harness.traced_window``) puts this summary in
its own under ``spans``, and the change of the program's counters across
the window under ``counters``; ``readings`` turns both into the per-layer
readings that the readers ``metrics/lm_*_ms.py``, ``solve_idle_pct.py``
and ``h2d_copies_per_batch.py`` report, and ``lines`` into the run's
``spans:``, ``counters:`` and ``runtime:`` lines (per batch). The command
is that traced run (``run.py --trace 1``'s, on any ``--device``): it
prints the run's lines and, last, one JSON object with the readings. The
benchmark's own runs never run it. A program without
``ezpz_tpu_torch.tracing`` gives no counters and puts every device second
under ``outside``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    # As ``run.py``: one host thread for the CPU's arithmetic.
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[_var] = "1"

from portbench import trace  # noqa: E402

PREFIX = "ezpz."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SOLVE = "ezpz.batch.solve"
# Runtime calls counted a batch: a blocking copy is a copy and a sync.
RUNTIME_SHOWN = ("cudaMemcpyAsync", "cudaStreamSynchronize")


def _interval(e):
    t = float(e["ts"])
    return t, t + float(e["dur"])


def _innermost(spans, times):
    """For each query time, the index in ``spans`` (sorted by start, the
    longer first) of the innermost span open then on one thread, or None."""
    out = [None] * len(times)
    stack, i = [], 0
    for q in sorted(range(len(times)), key=lambda k: times[k]):
        t = times[q]
        while i < len(spans) and spans[i][0] <= t:
            while stack and spans[stack[-1]][1] < spans[i][0]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
        out[q] = stack[-1] if stack else None
    return out


def window(events):
    """The window's (start, end) in the trace's microseconds."""
    for e in events:
        if (e.get("ph") == "X" and e.get("name") == trace.WINDOW
                and e.get("cat") in trace.HOST_CATS):
            return _interval(e)
    raise RuntimeError(f"the trace holds no {trace.WINDOW} annotation")


def summarize(events) -> dict:
    """The ``ezpz.*`` spans of a Chrome trace's ``traceEvents`` over the
    window (times in seconds)."""
    xs = [e for e in events if e.get("ph") == "X"]
    w0, w1 = window(xs)
    by_tid = defaultdict(list)
    for e in xs:
        if (e.get("cat") in trace.HOST_CATS and e["name"].startswith(PREFIX)
                and w0 <= float(e["ts"]) <= w1):
            by_tid[e.get("tid")].append((*_interval(e), e["name"]))
    for spans in by_tid.values():
        spans.sort(key=lambda s: (s[0], -s[1]))
    rows = defaultdict(lambda: dict(count=0, host_s=0.0, self_s=0.0, device_s=0.0, idle_s=0.0))
    for spans in by_tid.values():
        parent = _innermost_parents(spans)
        for k, (a, b, name) in enumerate(spans):
            rows[name]["count"] += 1
            rows[name]["host_s"] += (b - a) / 1e6
            rows[name]["self_s"] += (b - a) / 1e6
            if parent[k] is not None:
                rows[spans[parent[k]][2]]["self_s"] -= (b - a) / 1e6

    launches = {}
    for e in xs:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launches[corr] = (float(e["ts"]), e.get("tid"))
    device = [e for e in xs if e.get("cat") in trace.DEVICE_CATS and w0 <= float(e["ts"]) <= w1]
    outside = dict(device_s=0.0, idle_s=0.0)
    unattributed = dict(device_s=0.0)
    queries = defaultdict(list)  # tid -> [(launch time, device seconds)]
    for e in device:
        a, b = _interval(e)
        seconds = (min(b, w1) - max(a, w0)) / 1e6
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is None:
            unattributed["device_s"] += seconds
        else:
            queries[launch[1]].append((launch[0], seconds))
    for tid, qs in queries.items():
        spans = by_tid.get(tid, [])
        for (_t, seconds), k in zip(qs, _innermost(spans, [t for t, _s in qs])):
            (outside if k is None else rows[spans[k][2]])["device_s"] += seconds

    busy = trace._merged((max(a, w0), min(b, w1)) for a, b in map(_interval, device))
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    # Gaps are named on the thread that runs the solves (the most spans).
    main = max(by_tid, key=lambda t: len(by_tid[t])) if by_tid else None
    spans = by_tid.get(main, [])
    for (a, b), k in zip(gaps, _innermost(spans, [(a + b) / 2 for a, b in gaps])):
        (outside if k is None else rows[spans[k][2]])["idle_s"] += (b - a) / 1e6
    solves = trace._merged((a, b) for a, b, name in spans if name == SOLVE)
    solve_idle = sum(max(0.0, min(b, d) - max(a, c)) for a, b in gaps for c, d in solves)
    runtime = defaultdict(int)
    for e in xs:
        if (e.get("cat") in LAUNCH_CATS and e["name"] in RUNTIME_SHOWN
                and w0 <= float(e["ts"]) <= w1):
            runtime[e["name"]] += 1
    return {"window_s": (w1 - w0) / 1e6, "busy_s": sum(b - a for a, b in busy) / 1e6,
            "spans": dict(rows), "outside": outside, "unattributed": unattributed,
            "solve_idle_s": solve_idle / 1e6, "runtime": dict(sorted(runtime.items()))}


def _innermost_parents(spans):
    """For each span (sorted by start, the longer first), the index of the
    innermost span that encloses it, or None."""
    out, stack = [], []
    for k, (a, b, _name) in enumerate(spans):
        while stack and spans[stack[-1]][1] < b:
            stack.pop()
        out.append(stack[-1] if stack else None)
        stack.append(k)
    return out


def readings(spans: dict, counters: dict, batches: int) -> dict:
    """The per-layer readings of a summary over ``batches`` batches: device
    ms a batch under the Jacobian, assembly and damped-solve spans, the
    idle share inside ``ezpz.batch.solve`` (percent of the window), and
    the host-to-device copies a batch. A reading whose span or counter is
    absent is left out, and the idle share where nothing ran on the device
    (as ``device_idle_pct``)."""
    out = {}
    for metric, name in (("lm_jacobian_ms", "ezpz.lm.jacobian"),
                         ("lm_assembly_ms", "ezpz.lm.assemble"),
                         ("lm_damped_solve_ms", "ezpz.lm.damped_solve")):
        if name in spans["spans"]:
            out[metric] = 1e3 * spans["spans"][name]["device_s"] / batches
    if SOLVE in spans["spans"] and spans["busy_s"] > 0:
        out["solve_idle_pct"] = 100.0 * spans["solve_idle_s"] / spans["window_s"]
    if "h2d.copies" in counters:
        out["h2d_copies_per_batch"] = counters["h2d.copies"] / batches
    return out


def reading(summary: dict, name: str):
    """The reading ``name`` of ``readings`` over a traced run's summary
    (``harness.traced_window``); None where it is absent or nothing ran on
    the device."""
    if summary["busy_s"] <= 0:
        return None
    return readings(summary["spans"], summary["counters"], summary["iterations"]).get(name)


def lines(summary: dict) -> list:
    """The ``spans:``, ``counters:`` and ``runtime:`` lines of a traced
    run's summary, a batch: span counts and host, self, device and idle
    ms; the counters' changes; the blocking runtime calls."""
    found, count = summary["spans"], summary["iterations"]
    per = 1e3 / count
    return [
        "spans: " + json.dumps({
            **{name: {"count": r["count"] / count, "host_ms": r["host_s"] * per,
                      "self_ms": r["self_s"] * per, "device_ms": r["device_s"] * per,
                      "idle_ms": r["idle_s"] * per}
               for name, r in sorted(found["spans"].items())},
            "outside": {"device_ms": found["outside"]["device_s"] * per,
                        "idle_ms": found["outside"]["idle_s"] * per},
            "unattributed": {"device_ms": found["unattributed"]["device_s"] * per}}),
        "counters: " + json.dumps({k: v / count for k, v in sorted(summary["counters"].items())}),
        "runtime: " + json.dumps({k: v / count for k, v in found["runtime"].items()}),
    ]


def program_counts() -> dict:
    """The program's counters (``ezpz_tpu_torch.tracing.counts()``), or
    none where it has no ``tracing``."""
    try:
        from ezpz_tpu_torch import tracing
    except ImportError:
        return {}
    return tracing.counts()


def main(argv=None, overrides=None) -> int:
    """The command; ``overrides`` resizes the cell (``harness.Cell``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from portbench import harness

    result, run_lines = harness.run_cell(args.workload, args.seed, 0.0, True,
                                         device=args.device, overrides=overrides)
    for line in run_lines:
        print(line, flush=True)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "correct": result["correct"], **result["device"],
                      "idle_gaps": result["breakdown"]["idle_gaps"],
                      **{k: v["value"] for k, v in result["metrics"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
