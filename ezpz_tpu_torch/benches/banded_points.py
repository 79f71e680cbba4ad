"""Time the banded SPD kernel (``ops/banded.banded_spd_solve`` on the card)
at a few operating points, beside its bound and the dense library solve.

For each point ``B:n:bw`` (lanes, rows, half-bandwidth) and each dtype it
builds seeded, diagonally dominant bands (``make_band``), calls the kernel
once to warm it, then times REPS calls with CUDA events and prints the
median: ms per call, us per row (time / n), ns per row per lane
(time / (n B)), the bound (band, right-hand side and x moved once against
the factor's and both substitutions' operations, the formula of
``chip_smoke.banded_bound_ms``), the dense ``cholesky_ex`` +
``cholesky_solve`` of the same matrices where they fit, and a hash of x
(two trees' kernels must agree bit for bit). Beside the wrapper's own
route, every kernel that takes the band is timed with the route forced
(``banded_spd.route_for`` replaced for those calls): up to 32 the warp
kernel, up to 16 the one-thread-per-lane kernel (older checkouts' up to
32), from 32 the dynamic-width kernel up to its limit, and the
general-width kernel at any width (the ``crossover`` sweep only the warp
and lane kernels). It uses only the wrapper's call, its route function
and launch counts, so it also runs against older checkouts (parent,
change, change, parent in one call).

    python -m ezpz_tpu_torch.benches.banded_points                      # the card
    python -m ezpz_tpu_torch.benches.banded_points --sweep lanes        # the lane kernel's A/B
    python -m ezpz_tpu_torch.benches.banded_points --sweep crossover    # LANES_MIN_BATCH's
    python -m ezpz_tpu_torch.benches.banded_points --sweep crossover --rows 162,386
    python -m ezpz_tpu_torch.benches.banded_points --points 1024:952:11 --dtypes f64
    python -m ezpz_tpu_torch.benches.banded_points --cpu --points 3:20:2  # plain version

The named sweeps: ``lanes``, the lane kernel against the warp kernel at
n = 952 (phase 8's boundary), B of 2,048 to 16,384 at bw = 11 and B =
8,192 at bw 4, 16, 24 and 32 (past 16 the lane kernel has no capacity:
the warp kernel alone, and older checkouts' lane kernel); ``crossover``,
the warp and lane kernels alone at B of 32 to 8,192 at the top width of
every lane capacity (bw = capacity), which
``ops/banded_spd.LANES_MIN_BATCH`` is read from. ``--rows`` puts a
sweep's points at other n (the band tier's topologies: n = 162 for
``rect_grid(8, 8)``, 386 for ``rect_chain(64)``), each point at every n
given.

``--cpu`` runs the plain version on the host CPU with the host clock; its
times are the CPU's, not the card's.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

DEFAULT_POINTS = ("1024:952:11", "1:19992:11", "8192:952:11")
SWEEPS = {
    "lanes": ("2048:952:11", "4096:952:11", "8192:952:11", "16384:952:11", "8192:952:4",
              "8192:952:16", "8192:952:24", "8192:952:32"),
    "crossover": tuple(f"{B}:952:{cap}" for cap in (1, 2, 4, 8, 12, 16)
                       for B in (32, 256, 1024, 2048, 4096, 8192)),
}
# The routes a sweep forces besides the wrapper's own (every route that
# takes the band where a sweep is not named).
SWEEP_ROUTES = {"crossover": {"warp", "lanes"}}
DTYPES = {"f32": torch.float32, "f64": torch.float64}
# The H100's published rates (NVIDIA's data sheet, SXM): HBM bytes/s and
# f32 / f64 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
# The dense library solve is timed only when its matrix and factor fit.
LIBRARY_MAX_BYTES = 24 << 30


def make_band(B: int, n: int, bw: int, dtype=torch.float64, device="cpu", seed: int = 0):
    """Lower bands ``Ab`` (B, n, bw+1) of symmetric diagonally dominant
    matrices, as ``tests/test_torch_cuda.py``'s ``_spd_bands`` makes them
    (off-diagonal entries uniform in [-1, 1], the diagonal 2 bw + 1; zero
    left of the first column), and right-hand sides ``b`` (B, n) uniform
    in [-1, 1], from numpy's generator with ``seed``."""
    rng = np.random.default_rng(seed)
    Ab = rng.uniform(-1.0, 1.0, (B, n, bw + 1))
    Ab[:, :, bw] = 2.0 * bw + 1.0
    rows = np.arange(n)[:, None]
    Ab[:, (rows - bw + np.arange(bw + 1)[None, :]) < 0] = 0.0
    b = rng.uniform(-1.0, 1.0, (B, n))
    return (torch.as_tensor(Ab, dtype=dtype, device=device),
            torch.as_tensor(b, dtype=dtype, device=device))


def bound_ms(B: int, n: int, bw: int, itemsize: int):
    """(ms, "bytes" or "operations"): ``chip_smoke.banded_bound_ms``."""
    nbytes = B * n * (bw + 3) * itemsize + B
    ops = B * n * (bw * bw + 7 * bw + 6)
    rate = F32_OPS_PER_S if itemsize == 4 else F64_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def dense_of(Ab: torch.Tensor) -> torch.Tensor:
    """The dense symmetric matrices (B, n, n) of lower bands ``Ab``."""
    B, n, bwp1 = Ab.shape
    bw = bwp1 - 1
    dense = torch.zeros((B, n, n), dtype=Ab.dtype, device=Ab.device)
    rows = torch.arange(n, device=Ab.device)[:, None]
    cols = rows - bw + torch.arange(bwp1, device=Ab.device)[None, :]
    keep = (cols >= 0).expand(n, bwp1)
    r_idx, c_idx = rows.expand(n, bwp1)[keep], cols[keep]
    dense[:, r_idx, c_idx] = Ab[:, keep]
    dense[:, c_idx, r_idx] = Ab[:, keep]
    return dense


def events_ms(fn, reps: int) -> float:
    """Median ms of ``fn()`` between two CUDA events over ``reps`` calls,
    after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    return statistics.median(times)


def host_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def parse_point(text: str):
    parts = text.split(":")
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(f"point {text!r} is not B:n:bw")
    B, n, bw = (int(p) for p in parts)
    if B < 1 or n < 1 or bw < 0:
        raise argparse.ArgumentTypeError(f"point {text!r} needs B >= 1, n >= 1, bw >= 0")
    return B, n, bw


def measure(B, n, bw, dtype, device, reps, seed, keep=None):
    """The records of one point and dtype: one per route on the card (the
    routes in ``keep`` only, when given), one for the plain version on the
    CPU."""
    from ezpz_tpu_torch.ops import _build, banded, banded_spd

    Ab, b = make_band(B, n, bw, dtype, device, seed)
    bound, bound_by = bound_ms(B, n, bw, Ab.element_size())
    base = dict(B=B, n=n, bw=bw, dtype=str(dtype).replace("torch.", ""),
                bound_ms=bound, bound_by=bound_by)
    if device == "cpu":
        x, fail = banded.banded_spd_solve(Ab, b)
        ms = host_ms(lambda: banded.banded_spd_solve(Ab, b), reps)
        return [dict(base, route="plain version, CPU host clock", ms=ms,
                     fails=int(fail.sum()),
                     x_sha256=hashlib.sha256(x.numpy().tobytes()).hexdigest()[:16])]
    # The wrapper's own route, then every kernel that takes the band with
    # the route forced (``route_for`` pointed at it for these calls): the
    # warp and lane kernels up to their widths, the dynamic-width kernel
    # from 32 to its limit, the general-width kernel at any width. Routes
    # the checkout's wrapper does not count are skipped, so that the script
    # runs against older checkouts too.
    launches = getattr(banded_spd, "LAUNCHES", None)
    routes = ["default"]
    if isinstance(launches, dict) and hasattr(banded_spd, "route_for"):
        lanes_capacity = getattr(banded_spd, "lanes_capacity", None)
        takes = {
            "lanes": bw <= 32 if lanes_capacity is None else lanes_capacity(bw) is not None,
            "warp": bw <= getattr(_build, "BANDED_CAPACITIES", (32,))[-1],
            "dynamic": hasattr(_build, "banded_dyn_max_bw")
            and 32 <= bw <= _build.banded_dyn_max_bw(Ab.element_size()),
            "general": True,
        }
        routes += [r for r in launches if takes.get(r, False) and (keep is None or r in keep)]
    out = []
    lib_ms = None
    dense_bytes = 2 * B * n * n * Ab.element_size()
    if dense_bytes <= LIBRARY_MAX_BYTES:
        dense = dense_of(Ab)

        def library():
            L, _info = torch.linalg.cholesky_ex(dense)
            return torch.cholesky_solve(b[..., None], L)

        lib_ms = events_ms(library, reps)
        del dense
        torch.cuda.empty_cache()
    def call():
        return banded.banded_spd_solve(Ab, b)

    route_for = getattr(banded_spd, "route_for", None)
    for route in routes:
        if route != "default":
            banded_spd.route_for = lambda *_a, _r=route: _r
        try:
            before = dict(launches) if isinstance(launches, dict) else None
            x, fail = call()
            torch.cuda.synchronize()
            took = (None if before is None else
                    [k for k in launches if launches[k] != before[k]])
            ms = events_ms(call, reps)
        finally:
            if route_for is not None:
                banded_spd.route_for = route_for
        if route != "default" and took != [route]:
            raise SystemExit(f"banded_points: forcing {route} launched {took}")
        out.append(dict(base, route=route if route != "default" else f"default {took}",
                        ms=ms, us_per_row=ms * 1e3 / n,
                        ns_per_row_per_lane=ms * 1e6 / (n * B), library_ms=lib_ms,
                        library_note=None if lib_ms is not None else
                        f"not timed: dense matrices and factor need {dense_bytes} bytes",
                        fails=int(fail.sum()),
                        x_sha256=hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]))
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", nargs="+", type=parse_point,
                    default=[parse_point(p) for p in DEFAULT_POINTS],
                    help="operating points B:n:bw (default: " + " ".join(DEFAULT_POINTS) + ")")
    ap.add_argument("--sweep", choices=sorted(SWEEPS),
                    help="a named set of points in place of --points")
    ap.add_argument("--rows", type=lambda t: [int(v) for v in t.split(",")],
                    help="comma-separated n: the sweep's points at each of these n")
    ap.add_argument("--dtypes", default="f32,f64", help="comma-separated f32, f64")
    ap.add_argument("--reps", type=int, default=5, help="timed calls per median")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="the plain version on the host CPU (host clock)")
    args = ap.parse_args(argv)
    if args.sweep:
        args.points = [parse_point(p) for p in SWEEPS[args.sweep]]
    if args.rows:
        args.points = [(B, n, bw) for n in args.rows for B, _n, bw in args.points]
    keep = SWEEP_ROUTES.get(args.sweep)
    dtypes = [DTYPES[d] for d in args.dtypes.split(",")]
    if args.cpu:
        device, card = "cpu", "host CPU (plain version)"
    else:
        if not torch.cuda.is_available():
            raise SystemExit("banded_points: no CUDA device (use --cpu for the plain version)")
        device, card = "cuda", card_line()
    print(f"banded_points on {card}; torch {torch.__version__}", flush=True)
    records = []
    for B, n, bw in args.points:
        for dtype in dtypes:
            for rec in measure(B, n, bw, dtype, device, args.reps, args.seed, keep):
                rec["card"] = card
                records.append(rec)
                lib = (f"{rec['library_ms']!r} ms" if rec.get("library_ms") is not None
                       else rec.get("library_note", "not timed"))
                per_row = (f", {rec['us_per_row']!r} us per row, "
                           f"{rec['ns_per_row_per_lane']!r} ns per row per lane"
                           if "us_per_row" in rec else "")
                print(f"B={B} n={n} bw={bw} {rec['dtype']} [{rec['route']}]: "
                      f"{rec['ms']!r} ms (median of {args.reps}){per_row}; H100 bound "
                      f"{rec['bound_ms']!r} ms ({rec['bound_by']}); dense cholesky_ex + "
                      f"cholesky_solve {lib}; fails {rec['fails']}; x sha256 "
                      f"{rec['x_sha256']}; card: {card}", flush=True)
    print(json.dumps({"banded_points": records}), flush=True)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
