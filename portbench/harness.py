"""One run of one cell, driven by data.

A cell is a ``workloads`` entry of ``BENCHMARK.json``: a configuration
(``configs/<config>.json``, whose ``sketch`` names its generator
``sketches/<sketch>.py`` and whose ``reference`` its plain reference
``reference/<reference>.py``), a traffic mix (``traffic/<traffic>.json``,
whose ``loop`` names its loop ``loops/<loop>.py``: ``Loop``, whose
``answers`` the check reads and whose ``work`` the readers count, and
``plant``, which breaks the call it times for the tests), its limits
(``limits/<cell>.json``) and its size for a rehearsal on the CPU
(``rehearsal/<cell>.json``, the tests'). A per-layer metric is read by
``metrics/<name>.py``, or, where there is none, by the reader of its
quantity, ``metrics/<name up to its last dot>.py`` (``device_idle_pct``
for ``device_idle_pct.fleet``), whose ``read(summary)`` takes it from the
traced run's summary (``traced_window``) or returns None. Nothing here
names a cell.

A run: set-up (the port loaded, the sketch built, the solvers made, the
input pool made on the device from the seed and every set in it solved
once), then either the measured window (``--trace 0``: the cell's
end-to-end metrics) or a fixed count of steady iterations under
``torch.profiler`` (``--trace 1``: its per-layer metrics), then the check
of the answers the window produced (``check.py``).
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import check, spans, trace

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "ezpz_tpu")
# Iterations run under the profiler before its window opens, so that the
# profiler's own start (CUPTI's first kernels) falls outside the window.
PROFILER_WARMUP = 2


def benchmark() -> dict:
    return json.loads(BENCHMARK.read_text())


def data(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def module(kind: str, name: str):
    """``<kind>/<name>.py`` (a name may hold dots) as a module."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The per-layer metric's reader: ``metrics/<metric>.py``, else that of
    its quantity, the name up to its last dot."""
    name = metric if (HERE / "metrics" / f"{metric}.py").is_file() else metric.rpartition(".")[0]
    return module("metrics", name)


def workload(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload {name!r} in {BENCHMARK.name}")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _applies(metric: dict, cell: str, e2e_names=None) -> bool:
    """An end-to-end metric (``e2e_names`` None) without ``workloads`` holds
    in every cell; a per-layer one in every cell that reports what it
    moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


class Cell:
    """A cell's configuration, traffic, limits, metrics and loop.
    ``overrides`` ({"config": {...}, "traffic": {...}}) resizes it for a
    rehearsal on the CPU."""

    def __init__(self, name: str, device, overrides=None):
        overrides = overrides or {}
        spec = workload(name)
        bench = benchmark()
        self.name = name
        self.chips = spec["chips"]
        self.device = torch.device(device)
        self.cfg = {**data("configs", spec["config"]), **overrides.get("config", {})}
        if "reference" not in self.cfg:
            raise SystemExit(f"portbench: configs/{spec['config']}.json names no reference "
                             f"(its key \"reference\": a module reference/<name>.py)")
        self.reference = module("reference", self.cfg["reference"])
        self.traffic = {**data("traffic", spec["traffic"]), **overrides.get("traffic", {})}
        self.limits = data("limits", name)
        self.end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"] if _applies(m, name, e2e)]
        self.sketch_mod = module("sketches", self.cfg["sketch"])
        self.sketch = self.sketch_mod.plain(self.cfg)
        self.loop = module("loops", self.traffic["loop"]).Loop(
            self.cfg, self.traffic, self.sketch_mod, self.sketch, self.device)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _counters():
    from ezpz_tpu_torch.ops import banded_spd, coarse_fleet, fused_fleet

    return {"fused_fleet": fused_fleet.LAUNCHES, "coarse_fleet": coarse_fleet.LAUNCHES,
            **{f"banded_spd.{k}": v for k, v in banded_spd.LAUNCHES.items()}}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def traced_window(cell: Cell, count: int, keep):
    """``count`` steady iterations of the cell's loop under
    ``torch.profiler``, after ``PROFILER_WARMUP`` more, keeping the
    answers of the iterations in ``keep``. Returns (the summary, systems
    attempted, systems solved). The summary is ``trace.summarize``'s over
    the window, with the program's spans (``spans.summarize``, the same
    trace), the change of its counters across the window (``counters``,
    read inside it) and the loop's count of the work (``work``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cell.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        cell.loop.run(count=PROFILER_WARMUP)
        cell.sync()
        with torch.profiler.record_function(trace.WINDOW):
            before = spans.program_counts()
            _wall, _iters, attempted, solved = cell.loop.run(count=count, keep=keep)
            cell.sync()
            after = spans.program_counts()
    path = trace.trace_path()
    prof.export_chrome_trace(str(path))
    events = trace.read_trace(path)
    path.unlink()
    summary = trace.summarize(events, count)
    summary["spans"] = spans.summarize(events)
    summary["counters"] = {k: v - before.get(k, 0) for k, v in after.items()
                           if v != before.get(k, 0)}
    summary["work"] = cell.loop.work(count)
    return summary, attempted, solved


def run_cell(name: str, seed: int, seconds: float, traced: bool, device="cuda",
             overrides=None, t_start=None):
    """One run. Returns (the result's JSON object, the lines for standard
    error, the check's lines last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("imports", time.perf_counter())]
    cell = Cell(name, device, overrides)
    marks.append(("sketch and solvers", time.perf_counter()))
    loop = cell.loop
    rng = np.random.default_rng(seed)
    loop.prepare(seed)
    cell.sync()
    marks.append(("pool and warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    before = _counters()
    lines = ["set-up: " + ", ".join(f"{k} {b - a!r} s" for (_, a), (k, b)
                                    in zip([("", t_start)] + marks, marks))]
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if not traced:
        keep = loop.keep_for(rng)
        wall, iters, attempted, solved = loop.run(seconds=seconds, keep=keep)
        found = {**loop.end_to_end(wall, solved), "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": found[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
        lines.append(f"window: {wall!r} s, {iters} iterations")
    else:
        count = cell.traffic["trace_iterations"]
        summary, attempted, solved = traced_window(cell, count, loop.keep_for(rng, count))
        for m in cell.per_layer:
            value = reader(m["name"]).read(summary)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = summary["breakdown"]
        lines.append(f"traced window: {summary['window_s']!r} s, {count} iterations, "
                     f"device busy {summary['busy_s']!r} s, {summary['kernels']} kernels")
        lines += spans.lines(summary)
    lines.append(f"LM trips: {json.dumps(loop.trips())}")
    after = _counters()
    lines.append("launch counters over the window: " + json.dumps(
        {k: after[k] - before[k] for k in after if after[k] != before[k]}))
    result["attempted"], result["failed"] = attempted, attempted - solved
    if cell.device.type == "cuda":
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(cell.device),
                            "count": cell.chips,
                            "memory_peak_bytes": torch.cuda.max_memory_allocated(cell.device)}
        lines.append(f"card: {card_line()}")
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if traced:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    lines.append(f"setup_s {setup_s!r}")

    found = check.numbers(cell.reference, cell.sketch, loop.answers(rng))
    result["correct"], result["checks"] = check.verdict(found, cell.limits)
    lines.append(f"checked {found['cases']} answers against the reference")
    lines += [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
              for k, v in result["checks"].items()]
    return result, lines
