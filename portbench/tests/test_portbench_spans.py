"""``portbench/spans.py``: the program's spans read from a hand-built Chrome
trace, checked by hand; the trace's summary (``trace.summarize``) and the
accepted readers on the same events; the spans and counters in the
summary of traced rehearsals on the CPU; and the command."""

import json

import pytest

from rehearsal import SEED, harness, overrides
from portbench import spans, trace


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# Window 0-1000 us. Host: batch.solve 100-700 > trip 200-600 > jacobian
# 210-300 (an aten op inside), read 500-590. Device: a kernel launched in
# the jacobian (230-280), one in the trip's own time (300-400), one before
# any span (60-90), a copy launched in the read (520-530), and a kernel
# with no launch event (800-820). The window's device-side twin lies
# elsewhere and is not the window.
EVENTS = [
    _x(trace.WINDOW, "user_annotation", 0, 1000),
    _x(trace.WINDOW, "gpu_user_annotation", 5000, 10, tid=7),
    _x("ezpz.batch.solve", "user_annotation", 100, 600),
    _x("ezpz.lm.trip", "user_annotation", 200, 400),
    _x("ezpz.lm.jacobian", "user_annotation", 210, 90),
    _x("aten::mul", "cpu_op", 215, 10),
    _x("ezpz.lm.read", "user_annotation", 500, 90),
    _x("cudaLaunchKernel", "cuda_runtime", 220, 3, corr=1),
    _x("cudaLaunchKernel", "cuda_runtime", 350, 3, corr=2),
    _x("cudaLaunchKernel", "cuda_runtime", 50, 3, corr=3),
    _x("cudaMemcpyAsync", "cuda_runtime", 510, 3, corr=5),
    _x("cudaStreamSynchronize", "cuda_runtime", 513, 20),
    _x("kernel_a", "kernel", 230, 50, tid=7, corr=1),
    _x("kernel_b", "kernel", 300, 100, tid=7, corr=2),
    _x("kernel_c", "kernel", 60, 30, tid=7, corr=3),
    _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 520, 10, tid=7, corr=5),
    _x("kernel_d", "kernel", 800, 20, tid=7, corr=99),
]


def test_spans_by_hand():
    found = spans.summarize(EVENTS)
    s = found["spans"]
    assert found["window_s"] == pytest.approx(1e-3)
    us = pytest.approx  # seconds compared in microseconds below
    assert {k: v["count"] for k, v in s.items()} == {
        "ezpz.batch.solve": 1, "ezpz.lm.trip": 1, "ezpz.lm.jacobian": 1, "ezpz.lm.read": 1}
    assert s["ezpz.batch.solve"]["host_s"] == us(600e-6)
    assert s["ezpz.batch.solve"]["self_s"] == us(200e-6)
    assert s["ezpz.lm.trip"]["self_s"] == us(220e-6)
    assert s["ezpz.lm.jacobian"]["self_s"] == us(90e-6)
    # Device seconds by the innermost span open at the launch.
    assert s["ezpz.lm.jacobian"]["device_s"] == us(50e-6)
    assert s["ezpz.lm.trip"]["device_s"] == us(100e-6)
    assert s["ezpz.lm.read"]["device_s"] == us(10e-6)
    assert s["ezpz.batch.solve"]["device_s"] == 0.0
    assert found["outside"]["device_s"] == us(30e-6)
    assert found["unattributed"]["device_s"] == us(20e-6)
    # Gaps 0-60 and 820-1000 outside; 90-230 and 530-800 in batch.solve;
    # 280-300 in the jacobian; 400-520 in the trip.
    assert found["outside"]["idle_s"] == us(240e-6)
    assert s["ezpz.batch.solve"]["idle_s"] == us(410e-6)
    assert s["ezpz.lm.jacobian"]["idle_s"] == us(20e-6)
    assert s["ezpz.lm.trip"]["idle_s"] == us(120e-6)
    # Idle inside batch.solve (100-700): 130 + 20 + 120 + 170 us.
    assert found["solve_idle_s"] == us(440e-6)

    base = trace.summarize(EVENTS, 1)
    device = (sum(v["device_s"] for v in s.values()) + found["outside"]["device_s"]
              + found["unattributed"]["device_s"])
    assert device == pytest.approx(base["busy_s"]) == pytest.approx(210e-6)
    idle = sum(v["idle_s"] for v in s.values()) + found["outside"]["idle_s"]
    assert idle == pytest.approx(base["window_s"] - base["busy_s"])


def test_readings_by_hand():
    found = spans.summarize(EVENTS)
    got = spans.readings(found, {"h2d.copies": 188}, 2)
    # No assembly or damped-solve span in the trace: those are left out.
    assert got == pytest.approx({"lm_jacobian_ms": 0.025, "solve_idle_pct": 44.0,
                                 "h2d_copies_per_batch": 94.0})
    assert spans.readings(found, {}, 1).keys() == {"lm_jacobian_ms", "solve_idle_pct"}


def test_summary_and_accepted_readers_on_the_same_events():
    base = trace.summarize(EVENTS, 1)
    assert set(base) == {"iterations", "window_s", "busy_s", "device_ops", "kernels",
                         "breakdown"}
    assert base["kernels"] == 4 and base["busy_s"] == pytest.approx(210e-6)
    # The idle gaps now carry the program's span names.
    gaps = dict(base["breakdown"]["idle_gaps"])
    assert gaps["ezpz.batch.solve"] == pytest.approx(410e-6)
    assert gaps["host outside any operation"] == pytest.approx(240e-6)
    base["work"] = {"batches": 1, "buckets": []}
    base["spans"] = spans.summarize(EVENTS)
    base["counters"] = {"h2d.copies": 94, "lm.band_steps": 3}
    expected = {"device_idle_pct.fleet": 79.0, "launches_per_batch.chain": 4.0,
                "torch_ops_ms.chain": 0.2, "fused_fleet.roofline_pct": None,
                "band_solve.roofline_pct": None,
                # The span readers, as ``spans.readings`` reads the same
                # events (test_readings_by_hand), over one batch.
                "lm_jacobian_ms.chain": 0.05, "lm_assembly_ms.chain": None,
                "lm_damped_solve_ms.chain": None, "h2d_copies_per_batch.chain": 94.0,
                "solve_idle_pct.fleet": 44.0}
    for m in harness.benchmark()["per_layer"]:
        got, want = harness.reader(m["name"]).read(base), expected[m["name"]]
        assert got == want if want is None else got == pytest.approx(want), m["name"]


def test_a_trace_without_spans_puts_everything_outside():
    plain = [e for e in EVENTS if not e["name"].startswith("ezpz.")]
    found = spans.summarize(plain)
    assert found["spans"] == {} and found["solve_idle_s"] == 0.0
    assert found["outside"]["device_s"] == pytest.approx(190e-6)
    assert spans.readings(found, {}, 1) == {}


def _lm_loop(cell):
    """The cell's rehearsal with the kernel modes off: the rehearsal's chain
    is small enough for the fused kernel's gate, and so takes the batched
    LM loop, as the full-size chain does past the gate."""
    small = overrides(cell)
    return {**small, "traffic": {**small["traffic"], "solver": {"precision": "mixed"}}}


LM_SPANS = ("ezpz.batch.solve", "ezpz.lm.trip", "ezpz.lm.read", "ezpz.lm.jacobian",
            "ezpz.lm.assemble", "ezpz.lm.damped_solve", "ezpz.lm.eval")


@pytest.mark.parametrize("cell,lm_loop", [("massive.fleet", False), ("chain64.fleet", True)])
def test_traced_summary_carries_spans_and_counters(cell, lm_loop):
    """The traced window's summary on the CPU: the program's spans from the
    same trace, and its counters' change across the window (the chain's
    host-to-device copies, which the fused kernel's path makes none of);
    the span readers read nothing, since no device ran."""
    c = harness.Cell(cell, "cpu", _lm_loop(cell) if lm_loop else overrides(cell))
    c.loop.prepare(SEED)
    summary, attempted, solved = harness.traced_window(c, 2, set())
    assert attempted == solved > 0
    found = summary["spans"]["spans"]
    assert found["ezpz.batch.solve"]["count"] >= 2
    assert summary["spans"]["window_s"] == pytest.approx(summary["window_s"])
    if lm_loop:
        assert all(found[name]["count"] >= 2 for name in LM_SPANS)
        assert summary["counters"]["h2d.copies"] > 0
    for name in ("lm_jacobian_ms", "solve_idle_pct", "h2d_copies_per_batch"):
        assert spans.reading(summary, name) is None, name


def test_chain_rehearsal_reads_every_span(capsys):
    """The command: the harness's traced run on the CPU at the rehearsal's
    size, its lines, then its readings. Every span of the batched LM loop
    opens in the window, the counter reads a batch's copies, and no device
    time is read, so no per-layer metric is written."""
    rc = spans.main(["--workload", "chain64.fleet", "--seed", "12345", "--device", "cpu"],
                    overrides=_lm_loop("chain64.fleet"))
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    line = json.loads(out[-1])
    assert line["correct"] and line["busy_s"] == 0.0
    assert not {m["name"] for m in harness.benchmark()["per_layer"]} & set(line)
    shown = {k: json.loads(v) for k, _, v in (o.partition(": ") for o in out[:-1])
             if k in ("spans", "counters", "runtime")}
    for name in LM_SPANS:
        assert shown["spans"][name]["count"] >= 1, name
    assert shown["spans"]["ezpz.batch.solve"]["count"] == 1.0
    assert shown["counters"]["h2d.copies"] > 0 and shown["runtime"] == {}
