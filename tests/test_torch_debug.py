"""The port's debug switches, as ``tests/test_debug_nans.py`` and
``tests/test_embed.py::test_dbg_jac_prints_jacobian`` hold the JAX
package's.

``EZPZ_TPU_DEBUG_NANS=1`` / ``EZPZ_TPU_DEBUG_INFS=1`` are read when
``ezpz_tpu_torch`` is imported, so each case runs in a subprocess: armed,
the first torch operation producing a NaN (Inf) raises
``FloatingPointError`` naming it; off (the default), nothing raises.
``EZPZ_TPU_DBG_JAC=1`` prints the dense Jacobian on every LM trip of the
public API's f64 solve and is part of the solver cache's key.
"""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NAN_PROBE = """
import torch
import ezpz_tpu_torch  # reads the switches at import
try:
    torch.sqrt(torch.tensor(-1.0, dtype=torch.float64))
    print("NO-RAISE")
except FloatingPointError as e:
    print("CAUGHT", e)
"""

INF_PROBE = """
import torch
import ezpz_tpu_torch
try:
    torch.tensor(1.0, dtype=torch.float64) / torch.tensor(0.0, dtype=torch.float64)
    print("NO-RAISE")
except FloatingPointError as e:
    print("CAUGHT", e)
"""

BASIC = """
import ezpz_tpu_torch as ez
ids = ez.IdGenerator()
p = ez.DatumPoint.new(ids); q = ez.DatumPoint.new(ids)
reqs = [ez.ConstraintRequest.highest_priority(c) for c in [
    ez.Constraint.Fixed(p.id_x(), 0.0), ez.Constraint.Fixed(p.id_y(), 0.0),
    ez.Constraint.Distance(p, q, 4.0)]]
guesses = [(p.id_x(), 0.1), (p.id_y(), -0.02), (q.id_x(), 4.4), (q.id_y(), 1.0)]
out = ez.solve(reqs, guesses, ez.Config(), device="cpu")
assert out.converged
print("ITERATIONS", out.iterations)
"""


def _run(code, **env_extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("EZPZ_TPU_DEBUG_NANS", "EZPZ_TPU_DEBUG_INFS", "EZPZ_TPU_DBG_JAC")}
    env.update(env_extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


@pytest.mark.parametrize("probe,var", [(NAN_PROBE, "EZPZ_TPU_DEBUG_NANS"),
                                       (INF_PROBE, "EZPZ_TPU_DEBUG_INFS")])
def test_switch_armed_raises_at_the_operation(probe, var):
    out = _run(probe, **{var: "1"})
    assert "CAUGHT" in out, out
    assert ("aten.sqrt" if probe is NAN_PROBE else "aten.div") in out
    assert ("NaN" if probe is NAN_PROBE else "Inf") in out


@pytest.mark.parametrize("probe,var", [(NAN_PROBE, "EZPZ_TPU_DEBUG_NANS"),
                                       (INF_PROBE, "EZPZ_TPU_DEBUG_INFS")])
@pytest.mark.parametrize("value", ["", "0"])
def test_switch_off_by_default(probe, var, value):
    """Off unless set to something but "" or "0": the solver's failure
    signal (NaN on a non-SPD factorization) must flow silently."""
    assert "NO-RAISE" in _run(probe, **{var: value})


def test_nan_switch_does_not_catch_infs():
    assert "NO-RAISE" in _run(INF_PROBE, EZPZ_TPU_DEBUG_NANS="1")


def test_armed_solve_runs_clean_and_catches_the_failure_signal():
    """Armed, a well-posed solve finishes (no operation of its path makes a
    NaN); a singular Gauss-Newton solve at lambda 0 is stopped at the
    operation that meets the singular pivot."""
    assert "ITERATIONS" in _run(BASIC, EZPZ_TPU_DEBUG_NANS="1")
    code = """
import torch
from ezpz_tpu_torch import solver
from ezpz_tpu_torch.constraints import Constraint
from ezpz_tpu_torch.datatypes import DatumPoint
from ezpz_tpu_torch.models.compiled import compile_system
s = compile_system([Constraint.Distance(DatumPoint(0, 1), DatumPoint(2, 3), 4.0)], n_vars=4)
try:
    solver.solve_gauss_newton(s, torch.tensor([[0.0, 0.0, 1.0, 0.0]], dtype=torch.float64),
                              5, 1e-8, 1e-12, 0.0)
    print("NO-RAISE")
except FloatingPointError as e:
    print("CAUGHT", e)
"""
    out = _run(code, EZPZ_TPU_DEBUG_NANS="1")
    assert "CAUGHT NaN produced by aten." in out, out
    assert "NO-RAISE" in _run(code)


def test_kernel_outputs_and_worker_threads():
    """The ctypes-bound kernels bypass the dispatcher: their wrappers call
    ``check_outputs``, which raises on an armed switch. Dispatch modes are
    per thread: a worker thread is checked inside ``armed_in_thread`` (as
    ``FleetSolver``'s and the service's workers are)."""
    code = """
import threading
import torch
import ezpz_tpu_torch
from ezpz_tpu_torch.utils import debug
nan = torch.empty(2, dtype=torch.float64)  # uninitialised: not checked
nan.numpy()[:] = [1.0, float("nan")]  # written outside the dispatcher
try:
    debug.check_outputs("the fused fleet kernel", nan)
    print("NO-RAISE")
except FloatingPointError as e:
    print("CAUGHT", e)
debug.check_outputs("the fused fleet kernel", torch.tensor([1.0]), torch.tensor([True]))
seen = {}
def worker(armed):
    try:
        if armed:
            with debug.armed_in_thread():
                torch.sqrt(torch.tensor(-1.0))
        else:
            torch.sqrt(torch.tensor(-1.0))
        seen[armed] = "NO-RAISE"
    except FloatingPointError:
        seen[armed] = "CAUGHT"
for armed in (True, False):
    t = threading.Thread(target=worker, args=(armed,))
    t.start(); t.join(60)
print("THREADS", seen[True], seen[False])
"""
    out = _run(code, EZPZ_TPU_DEBUG_NANS="1")
    assert "CAUGHT NaN produced by the fused fleet kernel" in out, out
    assert "THREADS CAUGHT NO-RAISE" in out, out


def test_dbg_jac_prints_jacobian_per_trip():
    """``EZPZ_TPU_DBG_JAC=1`` through ``ezpz_tpu_torch.solve``: one
    ``dbg-jac`` dump per LM trip (a residual-converged solve of k
    iterations takes k trips), none without it."""
    out = _run(BASIC, EZPZ_TPU_DBG_JAC="1")
    iterations = int(out.split("ITERATIONS")[1].split()[0])
    assert iterations >= 1
    assert out.count("dbg-jac: iteration ") == iterations, out
    assert "dbg-jac: iteration 0, dense Jacobian =\n[[" in out
    assert "dbg-jac" not in _run(BASIC)


def test_dbg_jac_is_in_the_solver_cache_key(monkeypatch):
    """The solver cache keys on the switch (a solver built without it never
    serves a solve with it), and with it the API keeps even a decomposable
    sketch on the monolithic path, whose dense Jacobian it prints."""
    from ezpz_tpu_torch import api
    from ezpz_tpu_torch.constraints import Constraint
    from ezpz_tpu_torch.models.compiled import CompiledSystem

    cons = [Constraint.Fixed(i, float(i)) for i in range(8)]
    monkeypatch.setenv("EZPZ_TPU_DECOMPOSE_MIN", "2")
    monkeypatch.delenv("EZPZ_TPU_DBG_JAC", raising=False)
    plain = api._get_system_and_solver(cons, [1.0] * 8, 8, 35, device="cpu")
    monkeypatch.setenv("EZPZ_TPU_DBG_JAC", "1")
    dbg = api._get_system_and_solver(cons, [1.0] * 8, 8, 35, device="cpu")
    assert dbg[1] is not plain[1]
    assert not isinstance(plain[0], CompiledSystem)
    assert isinstance(dbg[0], CompiledSystem)
