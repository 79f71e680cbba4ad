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


def _copy(tmp_path):
    """``portbench/`` and ``BENCHMARK.json`` copied to ``tmp_path``: (the
    copy's ``portbench``, every file's bytes before anything is added)."""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path / "portbench", {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}


def _rehearse_copy(tmp_path, code, *args):
    """``code`` run in the copy, with the rehearsal's module imported: the
    result it prints as its last line."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1] + '/portbench/tests'); "
            "import rehearsal; " + code)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path), *args], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": f"{tmp_path}:{REPO}"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _assert_unchanged(before):
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p


@pytest.mark.parametrize("verdict", ["agrees", "disagrees"])
def test_a_dropped_in_cell_needs_no_edit(tmp_path, verdict):
    """A new configuration naming a reference of its own, sketch, loop,
    traffic mix, limits, rehearsal size and per-layer metric, each a file of
    its own, plus new entries in BENCHMARK.json: the tests' rehearsal runs
    the new cell, with the solver settings the traffic file gives, and no
    file that was there changes. The check
    goes through the named reference: where its verdicts disagree with the
    program's, ``correct`` is false."""
    root, before = _copy(tmp_path)
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
    result = _rehearse_copy(
        tmp_path, "assert 'chain3.tiny' in rehearsal.CELLS; "
        "r, _ = rehearsal.rehearse('chain3.tiny', traced=True, seconds=0.1); "
        "print(json.dumps(r))")
    assert "window_s.tiny" in result["metrics"]
    assert result["attempted"] > 0 and result["failed"] == 0
    if verdict == "agrees":
        assert result["correct"], result["checks"]
    else:
        assert result["correct"] is False
        assert result["checks"]["flags_off"]["value"] > 0
    _assert_unchanged(before)


# A loop whose timed call is not ``BatchSolver.solve``, with its own
# ``plant``.
SCHUR_LOOP = '''"""The ``schur`` loop: batches of one sketch through
``parallel.BlockSchurSolver.solve_batch``, one batch in flight. The solver
takes guesses only, so every lane has the published parameters and its
own seeded guesses."""

import numpy as np
import torch

from portbench import harness
from portbench.reference.lm import Answer


class Loop(harness.module("loops", "fleet").Loop):
    def __init__(self, cfg, traffic, sketch_mod, sketch, device):
        from ezpz_tpu_torch.parallel import BlockSchurSolver

        self.cfg, self.traffic, self.sketch_mod, self.sketch = cfg, traffic, sketch_mod, sketch
        self.device = torch.device(device)
        self.copies = traffic["systems_per_batch"]
        cons = [r.constraint for r in sketch_mod.port_requests(cfg)]
        self.solver = BlockSchurSolver(cons, sketch.n_vars, device=self.device,
                                       **traffic["solver"])
        self.pool, self.steps, self.kept = [], [], {}

    def prepare(self, seed):
        gen = torch.Generator(device=self.device).manual_seed(seed % (1 << 63))
        self.pool = [self.sketch_mod.lanes(self.cfg, self.sketch, self.copies, False, gen,
                                           self.device) for _ in range(self.traffic["pool"])]
        self.steps = [int(self._solve(inp)[0].iterations.sum()) for inp in self.pool]

    def _solve(self, inp):
        return self.solver.solve_batch(inp[1])

    def _solved(self, out):
        res, sat = out
        return res.converged & sat.all(-1)

    def trips(self):
        return {"lane": [st / self.copies for st in self.steps]}

    def answers(self, rng):
        out = []
        per = min(self.traffic["check_systems_per_batch"], self.copies)
        for _k, (i, (res, sat)) in sorted(self.kept.items()):
            params, guesses = (t.cpu().numpy() for t in self.pool[i])
            for j in np.sort(rng.choice(self.copies, size=per, replace=False)):
                out.append((params[j], guesses[j],
                            Answer(res.x[j].cpu().numpy(), bool(res.converged[j]),
                                   sat[j].cpu().numpy())))
        return out

    def work(self, batches):
        return {"batches": batches}


def plant(patch, change):
    """``BlockSchurSolver.solve_batch`` returns ``change(x, x0s)`` as its
    coordinates, the rest as solved."""
    from ezpz_tpu_torch.parallel import block_schur

    real = block_schur.BlockSchurSolver.solve_batch

    def broken(self, x0s):
        res, sat = real(self, x0s)
        return res._replace(x=change(res.x, x0s)), sat

    patch(block_schur.BlockSchurSolver, "solve_batch", broken)
'''


@pytest.mark.parametrize("fault", ["none", "unchanged", "altered"])
def test_a_dropped_in_cell_on_another_solver_needs_no_edit(tmp_path, fault):
    """A cell whose loop times ``parallel.BlockSchurSolver.solve_batch``
    (the rehearsal chain at a few rectangles, two parts, a banded boundary),
    dropped in as new files and entries: its rehearsal is correct, and not
    correct under each of the check's faults, planted through that loop's
    own ``plant``. No file that was there changes."""
    root, before = _copy(tmp_path)
    (root / "loops/schur.py").write_text(SCHUR_LOOP)
    traffic = json.loads((root / "traffic/fleet_24k.json").read_text())
    traffic.update(loop="schur", solver={"precision": "f64", "n_parts": 2,
                                         "boundary_solver": "banded"})
    (root / "traffic/schur_chain.json").write_text(json.dumps(traffic))
    (root / "limits/chain.schur.json").write_text(
        (root / "limits/chain64.fleet.json").read_text())
    (root / "rehearsal/chain.schur.json").write_text(json.dumps(
        {"config": {"rectangles": 4},
         "traffic": {"systems_per_batch": 3, "pool": 2, "check_systems_per_batch": 3}}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "chain.schur", "config": "rect_chain64",
                               "traffic": "schur_chain", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    result = _rehearse_copy(
        tmp_path, "fault = sys.argv[2]\n"
        "if fault != 'none':\n"
        "    rehearsal.loop('chain.schur').plant(setattr, rehearsal.FAULTS[fault])\n"
        "r, _ = rehearsal.rehearse('chain.schur'); print(json.dumps(r))", fault)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["metrics"]["systems_per_s"]["value"] > 0
    if fault == "none":
        assert result["correct"], result["checks"]
    else:
        assert result["correct"] is False, result["checks"]
    _assert_unchanged(before)
