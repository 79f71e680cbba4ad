"""The port's serving layer (``ezpz_tpu_torch.serve``) against the JAX
package's (``ezpz_tpu.serve``), on the CPU.

Every case of ``tests/test_serve.py`` runs against the port with
``device="cpu"``, and:

* on ``tiny``, ``two_rectangles`` and ``square`` (all fully constrained)
  the port's f64 service and the JAX f64 service give equal ``converged``,
  ``iterations`` (the pinned f64 counts), ``unsatisfied``, ``precision``
  and ``iterations_comparable``, and points within 1e-9;
* with ``pallas_fused=True`` forced, the port's service (the fused
  kernel's plain version here) answers ``tiny`` as the JAX service does
  with its fused kernel in interpret mode: flags, iterations and labels
  equal, points within 1e-6;
* the auto rule resolves to f64 and no kernel on the CPU, and without a
  card the default device raises in the constructor;
* 8 concurrent requests with different guesses share batches, and each
  answer equals the same request's answer sent alone (flags and
  iterations equal, points within 1e-12);
* ``chain(129)`` (258 kernel instances, over the kernel gate's 256) is
  answered through the batched mixed path with ``kernel_ok`` False;
* the HTTP round trip through the port's ``make_handler``.

One JAX service serves the whole file (mixed default with the fused
kernel; f64 by per-request override), so the JAX side compiles little.
Every wait is bounded: ``solve_text(timeout=...)``, ``urlopen(timeout=...)``,
thread joins, and the services and server shut down in ``finally``.
"""

import json
import os
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ezpz_tpu import serve as jserve
from ezpz_tpu_torch import serve

from .helpers import CASES_DIR

TIMEOUT = 300.0
FULLY_CONSTRAINED = ("tiny", "two_rectangles", "square")


def _txt(name):
    with open(os.path.join(CASES_DIR, name, "problem.md")) as fh:
        return fh.read()


def _perturbed(name, rng, sigma):
    """The fixture's text with every point guess moved by N(0, sigma)."""
    def move(m):
        x, y = float(m.group(1)) + rng.normal(0, sigma), float(m.group(2)) + rng.normal(0, sigma)
        return f"roughly ({x!r}, {y!r})"
    return re.sub(r"roughly \(([^,]+),([^)]+)\)", move, _txt(name))


def _chain_text(n_points):
    """A pinned chain of unit distances along x: 2 n_points variables and
    2 n_points kernel instances."""
    lines = ["# constraints"] + [f"point p{i}" for i in range(n_points)] + ["p0 = (0, 0)"]
    for i in range(1, n_points):
        lines += [f"distance(p{i - 1}, p{i}, 1)", f"horizontal(p{i - 1}, p{i})"]
    lines += ["", "# guesses"]
    lines += [f"p{i} roughly ({i + 0.01 * (-1) ** i}, 0.02)" for i in range(n_points)]
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def jax_service():
    svc = jserve.SolverService(batch_window_ms=1.0, precision="mixed", pallas_fused=True)
    try:
        yield svc
    finally:
        svc.shutdown()


def _same_answer(a, b, atol):
    for key in ("converged", "iterations", "unsatisfied", "precision",
                "iterations_comparable"):
        assert a[key] == b[key], (key, a[key], b[key])
    assert a["points"].keys() == b["points"].keys()
    for label in a["points"]:
        np.testing.assert_allclose(a["points"][label], b["points"][label], rtol=0,
                                   atol=atol, err_msg=label)


def test_hello():
    assert "ready" in serve.hello()
    assert "TPU" not in serve.hello()


def test_service_single_solve():
    svc = serve.SolverService(device="cpu")
    try:
        out = svc.solve_text(_txt("tiny"), timeout=TIMEOUT)
        assert out["converged"]
        assert abs(out["points"]["q"][0]) < 1e-4
        assert abs(out["points"]["q"][1]) < 1e-4
        assert out["precision"] == "f64"
        assert out["iterations_comparable"] is True
    finally:
        svc.shutdown()


@pytest.mark.parametrize("name", FULLY_CONSTRAINED)
def test_f64_service_matches_jax(name, jax_service):
    svc = serve.SolverService(batch_window_ms=1.0, device="cpu")
    try:
        out = svc.solve_text(_txt(name), timeout=TIMEOUT)
    finally:
        svc.shutdown()
    ref = jax_service.solve_text(_txt(name), timeout=TIMEOUT, precision="f64")
    assert ref["precision"] == "f64"
    _same_answer(out, ref, atol=1e-9)


def test_service_batches_concurrent_same_topology():
    """8 concurrent requests (seeded guesses) share batches; each answer is
    the one the request gets alone."""
    rng = np.random.default_rng(5)
    texts = [_perturbed("two_rectangles", rng, 1e-2) for _ in range(8)]
    svc = serve.SolverService(batch_window_ms=50.0, device="cpu")
    try:
        svc.solve_text(_txt("two_rectangles"), timeout=TIMEOUT)  # build the solver
        results = [None] * 8
        errors = []

        def work(i):
            try:
                results[i] = svc.solve_text(texts[i], timeout=TIMEOUT)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert not errors
        assert all(r is not None and r["converged"] for r in results)
        # The 8 concurrent requests must have shared batches.
        assert svc.stats["batches"] < svc.stats["requests"]
        batches = svc.stats["batches"]
        alone = [svc.solve_text(t, timeout=TIMEOUT) for t in texts]
        assert svc.stats["batches"] == batches + 8
    finally:
        svc.shutdown()
    for r, a in zip(results, alone):
        _same_answer(r, a, atol=1e-12)


def test_service_mixed_precision():
    svc = serve.SolverService(batch_window_ms=1.0, precision="mixed", device="cpu")
    try:
        out = svc.solve_text(_txt("tiny"), timeout=TIMEOUT)
        assert out["converged"]
        assert not out["unsatisfied"]
        assert "points" in out
        assert out["precision"] == "mixed"
        assert out["iterations_comparable"] is False
    finally:
        svc.shutdown()


def test_service_fused_auto_rule_and_forced_path(jax_service):
    """On the CPU the auto rule picks f64 and no kernel. Forced, the fused
    path (the kernel's plain version on CPU tensors) answers as the JAX
    service's fused kernel in interpret mode does."""
    svc = serve.SolverService(batch_window_ms=1.0, device="cpu")
    try:
        assert svc.precision == "f64"
        assert svc.pallas_fused is False
        svc.solve_text(_txt("tiny"), timeout=TIMEOUT)
        (batch_solver, _system), = svc._solvers.values()
        assert not batch_solver.pallas_fused and not batch_solver.kernel_ok
    finally:
        svc.shutdown()
    svc = serve.SolverService(batch_window_ms=1.0, precision="mixed", device="cpu")
    try:
        assert svc.pallas_fused is False
    finally:
        svc.shutdown()

    svc = serve.SolverService(batch_window_ms=1.0, precision="mixed",
                              pallas_fused=True, device="cpu")
    try:
        out = svc.solve_text(_txt("tiny"), timeout=TIMEOUT)
        assert out["converged"]
        assert not out["unsatisfied"]
        assert out["precision"] == "mixed"
        # the group's solver really is the fused configuration
        (batch_solver, _system), = svc._solvers.values()
        assert batch_solver.pallas_fused and batch_solver.kernel_ok
    finally:
        svc.shutdown()
    ref = jax_service.solve_text(_txt("tiny"), timeout=TIMEOUT)
    (jsolver, _), = [v for k, v in jax_service._solvers.items() if k[1] == "mixed"]
    assert any(v is not None for v in jsolver._fused_runs.values())
    _same_answer(out, ref, atol=1e-6)


def test_block_solver_fused_path_matches_f64():
    """BlockSolver(pallas_fused=True) reproduces the f64 decomposed solve
    on a multi-component sketch."""
    from ezpz_tpu_torch.config import Config
    from ezpz_tpu_torch.constraints import Constraint
    from ezpz_tpu_torch.datatypes import DatumLineSegment, DatumPoint
    from ezpz_tpu_torch.models.blocks import BlockSolver

    # three independent vertical-line components (the massive fixture's
    # unit), 4 vars each
    cons, x0 = [], []
    for k in range(3):
        p = DatumPoint(4 * k, 4 * k + 1)
        q = DatumPoint(4 * k + 2, 4 * k + 3)
        cons += [
            Constraint.Vertical(DatumLineSegment(p, q)),
            Constraint.Fixed(p.x_id, float(k)),
            Constraint.Fixed(p.y_id, 0.0),
            Constraint.Fixed(q.y_id, 4.0),
        ]
        x0 += [k + 0.3, -0.2, k + 0.8, 3.1]
    x0 = np.asarray(x0)

    ref = BlockSolver(cons, len(x0), config=Config(), device="cpu").solve(x0)
    fused = BlockSolver(cons, len(x0), config=Config(), precision="mixed",
                        pallas_fused=True, device="cpu")
    out = fused.solve(x0)
    assert any(s.pallas_fused and s.kernel_ok for s in fused._solvers)
    assert out.converged
    assert out.satisfied.all()
    np.testing.assert_allclose(out.x, ref.x, atol=1e-8)


def test_service_per_request_precision_override():
    svc = serve.SolverService(batch_window_ms=1.0, precision="mixed", device="cpu")
    try:
        out = svc.solve_text(_txt("tiny"), precision="f64", timeout=TIMEOUT)
        assert out["converged"]
        assert out["precision"] == "f64"
        assert out["iterations_comparable"] is True
        with pytest.raises(ValueError):
            svc.solve_text(_txt("tiny"), precision="f128", timeout=TIMEOUT)
    finally:
        svc.shutdown()


def test_service_parse_error():
    svc = serve.SolverService(device="cpu")
    try:
        with pytest.raises(ValueError):
            svc.solve_text("# constraints\nbogus(p)\n\n# guesses\np roughly (0,0)\n",
                           timeout=TIMEOUT)
    finally:
        svc.shutdown()


def test_over_gate_topology_takes_the_batched_path():
    """chain(129): 258 instances, over the kernel gate's 256, so the fused
    service answers it on the batched mixed path."""
    svc = serve.SolverService(batch_window_ms=1.0, precision="mixed",
                              pallas_fused=True, device="cpu")
    try:
        out = svc.solve_text(_chain_text(129), timeout=TIMEOUT)
        (batch_solver, system), = svc._solvers.values()
    finally:
        svc.shutdown()
    assert system.n_vars == 258
    assert batch_solver.pallas_fused and not batch_solver.kernel_ok
    assert out["converged"] and not out["unsatisfied"]
    assert out["precision"] == "mixed"
    np.testing.assert_allclose(out["points"]["p128"], [128.0, 0.0], atol=1e-6)


def test_constructor_checks():
    with pytest.raises(ValueError):
        serve.SolverService(precision="f128", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: tests/test_torch_cuda.py covers it")
    # No device: the card, so a machine without one raises here, before
    # any request is taken; the console script exits 1 with the reason.
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.SolverService()
    assert serve.main([]) == 1


def test_http_server_roundtrip():
    """The production handler (serve.make_handler) on an ephemeral port:
    solve roundtrip, /healthz stats, 404 routes, the X-Precision header,
    and the 400 error body for an unparseable problem."""
    from http.server import ThreadingHTTPServer

    service = serve.SolverService(precision="mixed", device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    try:
        req = urllib.request.Request(
            f"{base}/solve", data=_txt("tiny").encode(), method="POST")
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            out = json.loads(resp.read())
        assert out["converged"] and out["precision"] == "mixed"

        # X-Precision header forces the reference-exact path.
        req = urllib.request.Request(
            f"{base}/solve", data=_txt("tiny").encode(), method="POST",
            headers={"X-Precision": "f64"})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            out = json.loads(resp.read())
        assert out["precision"] == "f64" and out["iterations_comparable"]

        # /healthz reports stats.
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["ok"] and health["requests"] >= 2

        # Unknown routes 404 (GET and POST).
        for method, path in (("GET", "/nope"), ("POST", "/nope")):
            req = urllib.request.Request(
                f"{base}{path}", data=b"x" if method == "POST" else None,
                method=method)
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=30)
            assert e.value.code == 404

        # Unparseable body -> 400 with a JSON error payload.
        req = urllib.request.Request(
            f"{base}/solve", data=b"this is not a problem", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=TIMEOUT)
        assert e.value.code == 400
        assert "error" in json.loads(e.value.read())
    finally:
        server.shutdown()
        server.server_close()
        service.shutdown()
        t.join(timeout=30)
