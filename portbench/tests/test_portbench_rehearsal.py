"""Every cell of BENCHMARK.json runs end to end on the CPU at a tiny size,
untraced and traced, and its answers pass the check."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from rehearsal import CELLS, cell as rehearsal_cell, harness, overrides, rehearse

REPO = Path(__file__).resolve().parents[2]


def test_every_cell_has_a_rehearsal():
    """Every workload has its rehearsal file, which resizes only its
    configuration and traffic."""
    assert CELLS
    for name in CELLS:
        path = harness.HERE / "rehearsal" / f"{name}.json"
        assert path.is_file(), name
        assert set(json.loads(path.read_text())) <= {"config", "traffic"}, name


def test_a_configuration_without_a_reference_stops(monkeypatch):
    """No silent default: a configuration that names no reference module
    stops the run with a message that says so."""
    real = harness.data

    def data(kind, name):
        found = real(kind, name)
        return {k: v for k, v in found.items() if k != "reference"} if kind == "configs" else found

    monkeypatch.setattr(harness, "data", data)
    with pytest.raises(SystemExit, match="names no reference"):
        harness.Cell(CELLS[0], "cpu", overrides(CELLS[0]))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_window_is_correct(cell):
    result, lines = rehearse(cell)
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    names = {m["name"] for m in rehearsal_cell(cell).end_to_end}
    assert set(result["metrics"]) == names and "setup_s" in names
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert lines[-3:] == [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
                          for k, v in result["checks"].items()]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_traced_run_is_correct(cell):
    result, lines = rehearse(cell, traced=True)
    assert result["correct"], lines
    # No device ran: every device metric is left out, never written as 0.
    assert result["metrics"] == {}
    assert result["device"]["busy_s"] == 0.0 and result["device"]["window_s"] > 0
    assert len(result["breakdown"]["idle_gaps"]) <= 10


def test_command_without_a_card_prints_no_result():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "massive.fleet",
                           "--seed", str(2**40), "--seconds", "1", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_benchmark_json_names_every_file_it_needs():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    root = REPO / "portbench"
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file()
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (root / "reference" / f"{cfg['reference']}.py").is_file()
    for w in bench["workloads"]:
        traffic = root / "traffic" / f"{w['traffic']}.json"
        loop = json.loads(traffic.read_text())["loop"]
        assert (root / "loops" / f"{loop}.py").is_file()
        # The loop breaks its own timed call for the fault tests.
        assert callable(getattr(harness.module("loops", loop), "plant", None)), (
            f"loops/{loop}.py defines no plant(patch, change)")
        assert (root / "limits" / f"{w['name']}.json").is_file()
    for m in bench["per_layer"]:
        assert callable(harness.reader(m["name"]).read)
