"""What the command loads and reads, and what a later change adds."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "ezpz_tpu"}

GRAPH = r"""
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("portbench_run", "portbench/run.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from portbench import harness, readings
small = {"config": {"total_lines": 3, "rectangles": 5}}
for w in harness.benchmark()["workloads"]:
    harness.Cell(w["name"], "cpu", small)
for m in harness.benchmark()["per_layer"]:
    harness.reader(m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level_modules(code, *args):
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_command_imports_neither_jax_nor_the_jax_package():
    loaded = _top_level_modules(GRAPH, str(REPO))
    assert "ezpz_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import portbench.reference.lm, portbench.check, portbench.roofline; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = _top_level_modules(code, str(REPO))
    assert not loaded & (FORBIDDEN | {"ezpz_tpu_torch", "torch"})


def test_a_dropped_in_cell_needs_no_edit(tmp_path):
    """A new configuration, loop, traffic mix, per-layer metric and limits,
    each a file of its own, plus their entries: the harness runs the new
    cell, with the solver settings the traffic file gives, and no file that
    was there changes."""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    root = tmp_path / "portbench"
    cfg = json.loads((root / "configs/rect_chain64.json").read_text())
    cfg.update(name="rect_chain3", rectangles=3)
    (root / "configs/rect_chain3.json").write_text(json.dumps(cfg))
    (root / "loops/fleet_f64.py").write_text(
        "from portbench import harness\n"
        "SEEN = []\n"
        "class Loop(harness.module('loops', 'fleet').Loop):\n"
        "    def __init__(self, cfg, traffic, *args):\n"
        "        super().__init__(cfg, traffic, *args)\n"
        "        SEEN.extend(s.precision for s in self.solvers)\n"
        "        assert SEEN == ['f64']\n")
    traffic = json.loads((root / "traffic/fleet_24k.json").read_text())
    traffic.update(loop="fleet_f64", solver={"precision": "f64"}, systems_per_batch=2, pool=1,
                   trace_iterations=1)
    (root / "traffic/fleet_tiny.json").write_text(json.dumps(traffic))
    (root / "limits/chain3.tiny.json").write_text(
        (root / "limits/chain64.fleet.json").read_text())
    (root / "metrics/window_s.tiny.py").write_text(
        "def read(summary):\n    return summary['window_s']\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "rect_chain3", "source": "test",
                             "file": "portbench/configs/rect_chain3.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "chain3.tiny", "config": "rect_chain3",
                               "traffic": "fleet_tiny", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "window_s.tiny", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "device",
                               "moves": "systems_per_s", "workloads": ["chain3.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from portbench import harness; "
            "r, _ = harness.run_cell('chain3.tiny', 7, 0.1, True, device='cpu'); "
            "print(json.dumps(r))")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600,
                          env={**__import__("os").environ,
                               "PYTHONPATH": f"{tmp_path}:{REPO}"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and "window_s.tiny" in result["metrics"]
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p
