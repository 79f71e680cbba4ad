"""What the command loads and reads, and what a later change adds."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "ezpz_tpu"}

GRAPH = r"""
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("portbench_run", "portbench/run.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from portbench import harness, readings
for w in harness.benchmark()["workloads"]:
    harness.Cell(w["name"], "cpu", harness.data("rehearsal", w["name"]))
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
    """Every reference a configuration names, with the check and the
    roofline's yardstick."""
    names = sorted({json.loads(p.read_text())["reference"]
                    for p in (REPO / "portbench/configs").glob("*.json")})
    assert names
    code = ("import importlib, json, sys; sys.path.insert(0, sys.argv[1]); "
            "import portbench.check, portbench.roofline; "
            "[importlib.import_module('portbench.reference.' + n) for n in sys.argv[2:]]; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = _top_level_modules(code, str(REPO), *names)
    assert not loaded & (FORBIDDEN | {"ezpz_tpu_torch", "torch"})


# A reference of its own for the dropped-in cell: the float64 reference's
# answers, with the verdict turned over where it is to disagree.
TOY_REFERENCE = """import numpy as np
from portbench.reference import lm

residual, max_residual = lm.residual, lm.max_residual


def solve(sketch, params=None, guess=None, dtype=np.float64):
    answer = lm.solve(sketch, params, guess, dtype)
    return lm.Answer(answer.x, answer.converged != {flip}, answer.satisfied)
"""


@pytest.mark.parametrize("verdict", ["agrees", "disagrees"])
def test_a_dropped_in_cell_needs_no_edit(tmp_path, verdict):
    """A new configuration naming a reference of its own, sketch, loop,
    traffic mix, limits, rehearsal size and per-layer metric, each a file of
    its own, plus new entries in BENCHMARK.json: the tests' rehearsal runs
    the new cell, with the solver settings the traffic file gives, and no
    file that was there changes. The check
    goes through the named reference: where its verdicts disagree with the
    program's, ``correct`` is false."""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    root = tmp_path / "portbench"
    cfg = json.loads((root / "configs/rect_chain64.json").read_text())
    cfg.update(name="rect_chain3", rectangles=3, sketch="rect_pair", reference="toy_lm")
    (root / "configs/rect_chain3.json").write_text(json.dumps(cfg))
    (root / "reference/toy_lm.py").write_text(TOY_REFERENCE.format(flip=verdict != "agrees"))
    (root / "sketches/rect_pair.py").write_text(
        "from portbench import harness\n"
        "_chain = harness.module('sketches', 'rect_chain')\n"
        "plain, port_requests, lanes = _chain.plain, _chain.port_requests, _chain.lanes\n")
    (root / "loops/fleet_f64.py").write_text(
        "from portbench import harness\n"
        "SEEN = []\n"
        "class Loop(harness.module('loops', 'fleet').Loop):\n"
        "    def __init__(self, cfg, traffic, *args):\n"
        "        super().__init__(cfg, traffic, *args)\n"
        "        SEEN.extend(s.precision for s in self.solvers)\n"
        "        assert SEEN == ['f64']\n")
    traffic = json.loads((root / "traffic/fleet_24k.json").read_text())
    traffic.update(loop="fleet_f64", solver={"precision": "f64"})
    (root / "traffic/fleet_f64.json").write_text(json.dumps(traffic))
    (root / "limits/chain3.tiny.json").write_text(
        (root / "limits/chain64.fleet.json").read_text())
    (root / "rehearsal/chain3.tiny.json").write_text(json.dumps(
        {"traffic": {"systems_per_batch": 2, "pool": 1, "trace_iterations": 1}}))
    (root / "metrics/window_s.tiny.py").write_text(
        "def read(summary):\n    return summary['window_s']\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "rect_chain3", "source": "test",
                             "file": "portbench/configs/rect_chain3.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "chain3.tiny", "config": "rect_chain3",
                               "traffic": "fleet_f64", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "window_s.tiny", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "device",
                               "moves": "systems_per_s", "workloads": ["chain3.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1] + '/portbench/tests'); "
            "import rehearsal; assert 'chain3.tiny' in rehearsal.CELLS; "
            "r, _ = rehearsal.rehearse('chain3.tiny', traced=True, seconds=0.1); "
            "print(json.dumps(r))")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": f"{tmp_path}:{REPO}"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "window_s.tiny" in result["metrics"]
    assert result["attempted"] > 0 and result["failed"] == 0
    if verdict == "agrees":
        assert result["correct"], result["checks"]
    else:
        assert result["correct"] is False
        assert result["checks"]["flags_off"]["value"] > 0
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p
