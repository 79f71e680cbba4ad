"""Serving: an in-process solver service with micro-batching, plus a small
stdlib HTTP front end.

The PyTorch counterpart of ``ezpz_tpu/serve.py``. The reference's
embedding story is a WASM build for browsers (``ezpz-wasm/``); here it is a
long-lived service that keeps each topology's solver built and batches
concurrent same-topology requests into one batched solve, so the fleet path
is the serving fast path: on the card a group goes to the fused fleet
kernel (``csrc/fused_fleet.cu``) when the kernel gate admits its topology,
and to the batched mixed path otherwise.

Only the service's worker thread touches tensors; callers (the HTTP
handler threads included) enqueue a request and wait for its answer.

No external dependencies: ``http.server`` + threads. For real deployments
put this behind a proper ASGI gateway; the batching core is transport-
agnostic.

    python -m ezpz_tpu_torch.serve [--cpu] [port]     # console script: ezpz-torch-serve
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .utils import debug


def hello() -> str:
    """Smoke-test export (mirrors ezpz-wasm's ``hello()``)."""
    return "ezpz_tpu_torch: PyTorch/CUDA constraint solver ready"


@dataclass
class SolveRequest:
    problem_text: str
    # Per-request precision override ("f64" / "mixed"); None = service
    # default. Large-coordinate sketches that need reference-exact iteration
    # counts can force "f64" even when the service default is mixed.
    precision: Optional[str] = None
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[dict] = None
    error: Optional[str] = None


class SolverService:
    """Parses textual problems, caches each topology's solver, micro-batches
    same-topology requests arriving within ``batch_window_ms``.

    >>> svc = SolverService(batch_window_ms=1.0, device="cpu")
    >>> out = svc.solve_text('''
    ... # constraints
    ... point p
    ... p.x = 0
    ... p.y = 0
    ...
    ... # guesses
    ... p roughly (0.2, -0.1)
    ... ''')
    >>> svc.shutdown()
    >>> out["converged"], out["precision"], out["iterations_comparable"]
    (True, 'f64', True)
    >>> all(abs(v) < 1e-6 for v in out["points"]["p"])
    True
    """

    def __init__(self, batch_window_ms: float = 2.0, max_batch: int = 4096,
                 precision: str = "auto",
                 pallas_fused: Optional[bool] = None, device=None):
        """``device``: where every solve runs, the card unless the caller
        asks for another (``device="cpu"``); resolved here, so a machine
        without a card raises in the constructor.

        ``precision``: "f64", "mixed", or "auto" (default): auto picks the
        mixed f32+f64-refinement path on a CUDA device (iteration counts in
        responses then differ from the pure-f64 path; the same verified
        1e-8 tolerance) and plain f64 on the CPU.

        ``pallas_fused``: None (default) enables the fused fleet kernel for
        mixed-precision groups on a CUDA device only (on the CPU the
        wrapper takes the kernel's plain PyTorch version, correct but not
        a serving path). Eligibility stays per topology (the kernel gate,
        ``fleet_plan.kernel_admits``; other groups take the batched mixed
        path), and lanes the fixed-trip kernel leaves unconverged are
        finished through the full-budget batched path
        (``finish_stragglers``), so response semantics keep the full
        iteration budget. Pass True/False to force."""
        from .config import Config
        from .solver import resolve_device

        if precision not in ("auto", "f64", "mixed"):
            raise ValueError(f"precision must be 'auto', 'f64' or 'mixed', got {precision!r}")
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        if precision == "auto":
            # The CPU keeps the reference-exact path (mixed would change
            # reported iteration counts for no throughput reason there).
            precision = "mixed" if on_card else "f64"
        self.precision = precision
        if pallas_fused is None:
            pallas_fused = on_card
        self.pallas_fused = bool(pallas_fused)
        self.config = Config()
        self.batch_window = batch_window_ms / 1000.0
        self.max_batch = max_batch
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0}
        self._queue: "queue.Queue[SolveRequest]" = queue.Queue()
        self._solvers: Dict[tuple, object] = {}
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run_armed, daemon=True)
        self._worker.start()

    # -- public API ---------------------------------------------------------

    def solve_text(self, problem_text: str, timeout: float = 120.0,
                   precision: Optional[str] = None) -> dict:
        if precision is not None and precision not in ("f64", "mixed"):
            raise ValueError(f"precision must be 'f64' or 'mixed', got {precision!r}")
        req = SolveRequest(problem_text=problem_text, precision=precision)
        self._queue.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("solve timed out")
        if req.error is not None:
            raise ValueError(req.error)
        assert req.result is not None
        return req.result

    def shutdown(self) -> None:
        self._stop.set()
        self._queue.put(None)  # type: ignore[arg-type]
        self._worker.join(timeout=5)

    # -- batching core -------------------------------------------------------

    def _run_armed(self) -> None:
        """The worker thread: ``_run``, with an armed NaN/Inf switch
        reaching this thread too (``utils.debug``)."""
        with debug.armed_in_thread():
            self._run()

    def _run(self) -> None:
        while not self._stop.is_set():
            first = self._queue.get()
            if first is None:
                break
            batch = [first]
            deadline = time.monotonic() + self.batch_window
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._stop.set()
                    break
                batch.append(nxt)
            self._process(batch)

    def _process(self, batch: List[SolveRequest]) -> None:
        # Group by topology signature; same-topology requests solve as one
        # batch with per-request params/guesses.
        from .textual import Problem

        groups: Dict[tuple, List[Tuple[SolveRequest, object]]] = {}
        for req in batch:
            self.stats["requests"] += 1
            try:
                cs = Problem.from_str(req.problem_text).to_constraint_system()
                constraints = [r.constraint for r in cs.constraints]
                # Resolve tangency sides before keying (data-dependent).
                dense = [0.0] * len(cs.initial_guesses)
                for vid, val in cs.initial_guesses:
                    dense[vid] = val
                constraints = [c.set_from_initial_values(dense) for c in constraints]
                # Precision is part of the group key: a batch solves on ONE
                # path, so f64-override requests must not mix into a mixed
                # batch (and vice versa).
                prec = req.precision or self.precision
                key = (_structure_key(constraints, len(cs.initial_guesses)), prec)
                groups.setdefault(key, []).append((req, (cs, constraints)))
            except Exception as e:  # parse/build errors answer immediately
                req.error = str(e)
                req.done.set()

        for key, items in groups.items():
            try:
                self._solve_group(key, items)
            except Exception as e:
                for req, _ in items:
                    req.error = str(e)
                    req.done.set()

    def _solve_group(self, key, items) -> None:
        from .batch import BatchSolver
        from .models.compiled import compile_system

        self.stats["batches"] += 1
        self.stats["batched_requests"] += len(items)

        cs0, constraints0 = items[0][1]
        precision = key[1]
        n_vars = len(cs0.initial_guesses)
        solver = self._solvers.get(key)
        if solver is None:
            system = compile_system(constraints0, n_vars)
            fused = self.pallas_fused and precision == "mixed"
            solver = (
                BatchSolver(system, self.config, batch_params=True,
                            precision=precision, pallas_fused=fused,
                            device=self.device),
                system,
            )
            self._solvers[key] = solver
        batch_solver, system = solver

        # Guesses and per-request parameters are stacked on the host;
        # BatchSolver uploads x0 and each block's parameters once.
        B = len(items)
        x0 = np.zeros((B, n_vars))
        pars_list = []
        for i, (_req, (cs, constraints)) in enumerate(items):
            for vid, val in cs.initial_guesses:
                x0[i, vid] = val
            by_kind: Dict[str, list] = {}
            for c in constraints:
                for inst in c.lower():
                    by_kind.setdefault(inst.kernel, []).append(inst.params)
            pars_list.append(by_kind)
        pars = tuple(
            np.stack([
                np.asarray(pl[b.spec.name], dtype=np.float64).reshape(
                    len(pl[b.spec.name]), b.spec.nparams
                )
                for pl in pars_list
            ])
            for b in system.blocks
        )

        res = batch_solver.solve(
            x0, pars,
            # Keep full-iteration-budget response semantics when the
            # fixed-trip fused kernel serves the group (no-op otherwise).
            finish_stragglers=batch_solver.pallas_fused,
        )
        # One device-to-host copy per group: [x | sat | converged | iterations].
        dt = res.x.dtype
        host = torch.cat([res.x, res.satisfied.to(dt), res.converged[:, None].to(dt),
                          res.iterations[:, None].to(dt)], dim=1).cpu().numpy()
        sat = host[:, n_vars:-2] != 0.0
        for i, (req, (cs, _)) in enumerate(items):
            req.result = _format_outcome(
                cs, host[i, :n_vars], int(host[i, -1]), bool(host[i, -2]), sat[i],
                precision=precision,
            )
            req.done.set()


def _structure_key(constraints, n_vars: int) -> tuple:
    """Topology signature excluding params (they batch)."""
    items = []
    for c in constraints:
        for inst in c.lower():
            items.append((inst.kernel, inst.var_ids))
    return (n_vars, tuple(items))


def _format_outcome(cs, x: np.ndarray, iterations: int, converged: bool, sat,
                    precision: str = "f64") -> dict:
    from .textual.executor import VARS_PER_ARC, VARS_PER_CIRCLE, VARS_PER_POINT

    points = {}
    for i, label in enumerate(cs.inner_points):
        points[label] = [float(x[2 * i]), float(x[2 * i + 1])]
    start_c = VARS_PER_POINT * len(cs.inner_points)
    circles = {}
    for i, label in enumerate(cs.inner_circles):
        base = start_c + VARS_PER_CIRCLE * i
        circles[label] = {
            "center": [float(x[base]), float(x[base + 1])],
            "radius": float(x[base + 2]),
        }
    start_a = start_c + VARS_PER_CIRCLE * len(cs.inner_circles)
    arcs = {}
    for i, label in enumerate(cs.inner_arcs):
        base = start_a + VARS_PER_ARC * i
        arcs[label] = {
            "a": [float(x[base]), float(x[base + 1])],
            "b": [float(x[base + 2]), float(x[base + 3])],
            "center": [float(x[base + 4]), float(x[base + 5])],
        }
    unsat = [int(i) for i in np.nonzero(~np.asarray(sat))[0]]
    return {
        "converged": converged,
        "iterations": iterations,
        # Which solve path produced this answer. Mixed-precision iteration
        # counts (coarse f32 + f64 refine steps) are NOT comparable to the
        # reference's pure-f64 LM counts; ``iterations_comparable`` says so
        # explicitly so clients can't mistake one for the other.
        "precision": precision,
        "iterations_comparable": precision == "f64",
        "unsatisfied": unsat,
        "points": points,
        "circles": circles,
        "arcs": arcs,
    }


def benchmark(n: int = 100, device=None) -> float:
    """Times n sequential service solves of the two-rectangles system on
    ``device`` (the card unless asked otherwise) and returns solves/sec
    (mirrors ezpz-wasm's ``benchmark()``)."""
    import os

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(here, "tests", "cases", "two_rectangles", "problem.md")
    with open(path) as fh:
        txt = fh.read()
    svc = SolverService(device=device)
    try:
        svc.solve_text(txt)  # warm
        t0 = time.perf_counter()
        for _ in range(n):
            svc.solve_text(txt)
        dt = time.perf_counter() - t0
    finally:
        svc.shutdown()
    return n / dt


# -- HTTP front end ----------------------------------------------------------


def make_handler(service: "SolverService"):
    """The HTTP handler class bound to ``service`` — factored out of
    ``run_server`` so tests exercise the REAL production handler (routes,
    X-Precision header, error bodies) rather than a reimplementation."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                body = json.dumps({"ok": True, **service.stats}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            if self.path != "/solve":
                self.send_response(404)
                self.end_headers()
                return
            length = int(self.headers.get("Content-Length", "0"))
            text = self.rfile.read(length).decode()
            # Per-request path selection: "X-Precision: f64" forces the
            # reference-exact pure-f64 path (comparable iteration counts,
            # robust for large-coordinate sketches); "mixed" forces the
            # high-throughput path. Absent = service default.
            precision = self.headers.get("X-Precision") or None
            try:
                result = service.solve_text(text, precision=precision)
                body = json.dumps(result).encode()
                code = 200
            except Exception as e:
                body = json.dumps({"error": str(e)}).encode()
                code = 400
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def run_server(host: str = "127.0.0.1", port: int = 8787, device=None) -> None:
    """POST /solve with a textual problem body -> JSON outcome.
    GET /healthz -> service stats. Solves on ``device`` (the card unless
    asked otherwise)."""
    from http.server import ThreadingHTTPServer

    service = SolverService(device=device)
    try:
        server = ThreadingHTTPServer((host, port), make_handler(service))
        print(f"ezpz_tpu_torch serving on http://{host}:{port} (POST /solve), "
              f"solving on {service.device}", flush=True)
        try:
            server.serve_forever()
        finally:
            server.server_close()
    finally:
        service.shutdown()


def main(argv=None) -> int:
    """Console entry point: ``ezpz-torch-serve [--cpu] [port]``."""
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="ezpz-torch-serve",
        description="HTTP constraint-solver service on an NVIDIA GPU (PyTorch)")
    parser.add_argument("port", nargs="?", type=int, default=8787)
    parser.add_argument("--cpu", action="store_true",
                        help="Solve on the CPU instead of the GPU")
    args = parser.parse_args(argv)
    try:
        run_server(port=args.port, device="cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
