"""The roofline readers' work counts, checked by hand on tiny cases."""

import numpy as np

from rehearsal import harness
from portbench import roofline
from portbench.reference import lm


def _sketch(kinds, ids, n):
    return lm.Sketch(np.asarray(kinds), np.asarray(ids), np.zeros(len(kinds)), np.zeros(n))


def test_one_variable_lane_by_hand():
    # One fixed value: n 1, m 1, one parameter, reading one variable.
    sk = _sketch([lm.FIXED], [(0, 0, 0, 0)], 1)
    shape = roofline.component_shape(sk, [0], [0])
    assert shape == dict(n=1, m=1, params=1, reads=[1], bw=0)
    # Jacobian 1, JtJ 2 * 1, Jtr 2; factor 1*2*3/3 = 2; solves 2; update 3;
    # trial residual 3.
    assert roofline.step_ops(1, [1]) == 1 + 2 + 2 + 2 + 2 + 3 + 3
    # Bytes a lane: x0 8 + params 8, x 8 + iterations 4 + converged 1 +
    # satisfied and degenerate 2.
    bucket = dict(shape, lanes=1000, steps=2000)
    bytes_s = 2 * 1000 * 31 / roofline.HBM_BYTES_PER_S
    ops_s = 2000 * 15 / roofline.F32_OPS_PER_S
    assert np.isclose(roofline.fleet_bound_s([bucket], 2), max(bytes_s, ops_s))


def test_vertical_line_component_by_hand():
    # vertical(p, q) and p.x fixed: x ids 0 and 2 of points (0, 1), (2, 3).
    sk = _sketch([lm.VERTICAL, lm.FIXED], [(0, 1, 2, 3), (0, 0, 0, 0)], 4)
    shape = roofline.component_shape(sk, [0, 1], [0, 2])
    assert shape == dict(n=2, m=2, params=1, reads=[2, 1], bw=1)


def test_band_bound_by_hand():
    # 10 lanes, 5 rows, bw 2, float: 10*5*5*4 + 10 bytes; 10*5*(4+14+6) ops.
    t = roofline.band_bound_s(10, 5, 2, 4)
    assert np.isclose(t, max(1010 / roofline.HBM_BYTES_PER_S, 1200 / roofline.F32_OPS_PER_S))
    t64 = roofline.band_bound_s(10, 5, 2, 8)
    assert np.isclose(t64, max(2010 / roofline.HBM_BYTES_PER_S,
                               1200 / roofline.F64_OPS_PER_S))


def test_chain_band_is_the_programs():
    """The benchmark's own ordering of rect_chain64 finds the band the
    program's RCM planner finds (7)."""
    from ezpz_tpu_torch.models.compiled import compile_system
    from ezpz_tpu_torch.ops.banded import plan_band

    cell = harness.Cell("chain64.fleet", "cpu")
    sk = cell.sketch
    shape = roofline.component_shape(sk, np.arange(sk.n_constraints), np.arange(sk.n_vars))
    system = compile_system([r.constraint for r in cell.sketch_mod.port_requests(cell.cfg)],
                            sk.n_vars)
    assert shape["bw"] == plan_band(system)[1] == 7


def _readers():
    return {m["name"]: harness.reader(m["name"]) for m in harness.benchmark()["per_layer"]}


def test_readers_find_nothing_without_a_device():
    span = dict(count=2, host_s=0.1, self_s=0.1, device_s=0.0, idle_s=0.0)
    summary = {"iterations": 2, "window_s": 1.0, "busy_s": 0.0, "kernels": 0,
               "device_ops": {}, "work": {"batches": 2, "buckets": []},
               "spans": {"window_s": 1.0, "busy_s": 0.0, "solve_idle_s": 0.0,
                         "spans": {"ezpz.batch.solve": span, "ezpz.lm.jacobian": span}},
               "counters": {"h2d.copies": 176}}
    for name, mod in _readers().items():
        assert mod.read(summary) is None, name


def test_readers_by_hand():
    """A summary with two batches of one fused launch and one PyTorch
    kernel each, and one host-to-device copy; the program's spans charge
    1 ms of device time to its Jacobian and 0.5 ms to its damped solves,
    3 ms of idle fall inside its solves, and its counter reads 176 copies."""
    fused = "void fused_small_kernel<1, 1>(double const*)"
    summary = {"iterations": 2, "window_s": 0.01, "busy_s": 0.004, "kernels": 4,
               "device_ops": {fused: {"count": 2, "seconds": 0.002, "cat": "kernel"},
                              "void at::native::add": {"count": 2, "seconds": 0.001,
                                                       "cat": "kernel"},
                              "Memcpy HtoD (Pageable -> Device)": {
                                  "count": 1, "seconds": 0.001, "cat": "gpu_memcpy"}},
               "work": {"batches": 2, "buckets": [dict(n=1, m=1, params=1, reads=[1], bw=0,
                                                       lanes=10 ** 6, steps=2 * 10 ** 6)]},
               "spans": {"window_s": 0.01, "busy_s": 0.004, "solve_idle_s": 0.003,
                         "spans": {"ezpz.batch.solve": {"device_s": 0.0},
                                   "ezpz.lm.jacobian": {"device_s": 0.001},
                                   "ezpz.lm.damped_solve": {"device_s": 0.0005}}},
               "counters": {"h2d.copies": 176, "lm.band_steps": 6}}
    read = {name: mod.read(summary) for name, mod in _readers().items()}
    bound = roofline.fleet_bound_s(summary["work"]["buckets"], 2)
    assert np.isclose(read["fused_fleet.roofline_pct"], 100 * bound / 0.002)
    assert np.isclose(read["torch_ops_ms.chain"], 0.5)
    assert read["launches_per_batch.chain"] == 2
    assert np.isclose(read["device_idle_pct.fleet"], 60.0)
    assert read["band_solve.roofline_pct"] is None
    assert np.isclose(read["lm_jacobian_ms.chain"], 0.5)
    assert read["lm_assembly_ms.chain"] is None
    assert np.isclose(read["lm_damped_solve_ms.chain"], 0.25)
    assert read["h2d_copies_per_batch.chain"] == 88
    assert np.isclose(read["solve_idle_pct.fleet"], 30.0)
