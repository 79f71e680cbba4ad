"""Levenberg-Marquardt over an explicit batch of sketches.

The PyTorch counterpart of ``ezpz_tpu/solver.py`` (``solve_lm``,
``solve_lm_mixed``, ``solve_lm_refine`` and their helpers). The JAX package
writes one sketch's loop and ``vmap``s it; here every tensor carries a
leading batch axis of B lanes and the loop is written out:

* ``_lm_while_loop`` runs while any lane is live (not done, under its own
  iteration limit, residual above tolerance), one host sync per trip. A
  trip computes every lane and keeps the new state only on live lanes, as
  ``vmap`` of ``lax.while_loop`` does: a lane whose condition is false keeps
  all of its state, lambda and counters included.
* Semantics are the reference's (``ezpz/src/solver/newton.rs:29-145``):
  residual check at the top of a trip, step check at the bottom, a failed
  factorization is a rejected step, a step is accepted iff ``|r|^2``
  strictly drops, lambda times 0.1 on accept and 10 on reject.

``solve_gauss_newton`` is the reference's fixed-damping variant (no
accept/reject), and ``solve_lm_cg`` the same LM loop with a matrix-free
conjugate-gradient step (``_cg``, one host sync per CG trip) for systems
whose dense JtJ does not fit.

``make_solver`` is the public API's single-sketch solver: a batch of one
lane, packed into one tensor so that a solve costs one device-to-host copy.
``EZPZ_TPU_DBG_JAC=1`` makes its f64 loop print every lane's dense
Jacobian on every trip (the reference's ``dbg-jac`` feature).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from . import tracing
from .config import LM_LAMBDA_DECR, LM_LAMBDA_INCR
from .models.compiled import CompiledSystem
from .ops.banded import BandRoute
from .ops.device_cache import to_device
from .ops.linalg import spd_solve

# The mixed path's f32 phase: at most this many trips, toward this residual
# tolerance (just above f32 round-off for O(1) coordinates), both as the
# JAX package's ``solve_lm_mixed`` defaults them. The coarse fleet kernels
# use the same tolerance.
COARSE_MAX_ITERATIONS = 20
COARSE_TOLERANCE = 5e-6
# The f64-residual refinement's trip budget per lane (``solve_lm_refine``'s
# default in the JAX package, which its coarse-kernel path relies on).
REFINE_ITERATIONS = 6


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card (``"cuda"``) unless the
    caller names another. Raises when the card is wanted and there is
    none: the port never answers on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ezpz_tpu_torch solves on the GPU unless asked otherwise, and no "
            "CUDA device is available; pass device='cpu' to solve on the CPU")
    return dev


class LMState(NamedTuple):
    x: torch.Tensor  # (B, n)
    r: torch.Tensor  # (B, m)
    r2: torch.Tensor  # (B,)
    lam: torch.Tensor  # (B,)
    it: torch.Tensor  # (B,) int32
    done: torch.Tensor  # (B,) bool
    converged: torch.Tensor  # (B,) bool
    iterations: torch.Tensor  # (B,) int32
    deg: torch.Tensor  # (B, n_constraints) bool — any degenerate eval


class LMResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    deg: torch.Tensor
    residual: torch.Tensor  # weighted residual at the final x


def _rows_max_abs(r: torch.Tensor) -> torch.Tensor:
    """NaN-propagating max |row| per lane (0 for a system with no rows)."""
    if r.shape[-1] == 0:
        return torch.zeros(r.shape[:-1], dtype=r.dtype, device=r.device)
    return torch.amax(torch.abs(r), dim=-1)


def _init_state(system, x0, initial_lambda, lam_dtype=None, pars=None,
                deg_extra=None) -> LMState:
    """Initial LM state: residual (and flags) evaluated at the cast x0."""
    dtype = system.dtype
    x = x0.to(dtype)
    B = x.shape[0]
    r0, deg0 = system.residual_and_flags(x, pars)
    if deg_extra is not None:
        deg0 = deg0 | deg_extra
    zeros_i = torch.zeros((B,), dtype=torch.int32, device=x.device)
    false = torch.zeros((B,), dtype=torch.bool, device=x.device)
    return LMState(
        x=x, r=r0, r2=torch.sum(r0 * r0, dim=-1),
        lam=torch.full((B,), initial_lambda, dtype=lam_dtype or dtype, device=x.device),
        it=zeros_i, done=false, converged=false, iterations=zeros_i, deg=deg0,
    )


def _lm_while_loop(state: LMState, eval_fn, step_fn, limit, rtol, stol,
                   boundary_parity: bool, debug_fn=None):
    """The shared LM accept/reject loop over a batch.

    ``step_fn(s, live) -> (d, fail, deg_j)`` gives the damped step (and
    the Jacobian pass's degenerate flags) on every lane; only the ``live``
    lanes' steps are kept. ``eval_fn(x) -> (r, deg)`` gives the trial
    residual. ``limit``, ``rtol`` and ``stol`` are scalars or per-lane (B,)
    tensors. ``boundary_parity``: residual convergence counts only while
    steps remain (the reference never re-checks after its last iteration);
    the f64 refinement passes False. ``debug_fn(s, live)``, when given,
    runs at the top of every trip. Returns ``(final_state, res_conv)``.

    Spans (``tracing``): a trip (``ezpz.lm.trip``) runs from its dispatch
    to the read of the next trip's live lanes (``ezpz.lm.read``, where the
    host waits for the device); the trial residual is ``ezpz.lm.eval``."""
    s = state
    dtype = s.lam.dtype
    decr = to_device(LM_LAMBDA_DECR, dtype=dtype, device=s.lam.device)
    incr = to_device(LM_LAMBDA_INCR, dtype=dtype, device=s.lam.device)

    def read(s):
        live = ~s.done & (s.it < limit) & (_rows_max_abs(s.r) > rtol)
        with tracing.span("ezpz.lm.read"):
            go = bool(live.any())
        return live, go

    live, go = read(s)
    while go:
        with tracing.span("ezpz.lm.trip"):
            if debug_fn is not None:
                debug_fn(s, live)
            d, fail, deg_j = step_fn(s, live)
            step_inf = _rows_max_abs(d)
            x_new = s.x + d
            with tracing.span("ezpz.lm.eval"):
                r_new, deg_r = eval_fn(x_new)
            r2_new = torch.sum(r_new * r_new, dim=-1)
            accept = ~fail & (r2_new < s.r2)

            # One pass masked by ``live``: a lane whose loop condition is
            # false keeps all of its state. A live lane is not done and its
            # residual is above tolerance, so only the step check can end it.
            take = live & accept
            step_conv = live & ~fail & (step_inf <= stol)
            s = LMState(
                x=torch.where(take[:, None], x_new, s.x),
                r=torch.where(take[:, None], r_new, s.r),
                r2=torch.where(take, r2_new, s.r2),
                lam=torch.where(live, torch.where(accept, s.lam * decr, s.lam * incr), s.lam),
                it=torch.where(live, s.it + 1, s.it),
                done=s.done | step_conv,
                converged=s.converged | step_conv,
                iterations=torch.where(step_conv, s.it, s.iterations),
                deg=s.deg | ((deg_j | deg_r) & live[:, None]),
            )
            live, go = read(s)
    res_conv = _rows_max_abs(s.r) <= rtol
    if boundary_parity:
        res_conv = res_conv & (s.it < limit)
    return s, res_conv


def _reference_result(final: LMState, res_conv, max_iterations: int) -> LMResult:
    """Reference-exact outcome: residual convergence reports the steps taken
    so far; step convergence pinned its index inside the loop; an exhausted
    budget reports ``max_iterations`` with ``converged = False``."""
    iterations = torch.where(
        final.done, final.iterations,
        torch.where(res_conv, final.it, torch.full_like(final.it, max_iterations)))
    return LMResult(x=final.x, iterations=iterations,
                    converged=final.converged | res_conv, deg=final.deg,
                    residual=final.r)


def _rescued(solve, lam, diag):
    """``solve(lam)`` with ``damped_spd_solve``'s f32 singular-rescue retry:
    ``solve(max(lam, 1e-6 * max|diag|))`` on the lanes whose first solve
    failed, where ``diag`` (B, n) is the undamped diagonal."""
    d, fail = solve(lam)
    if diag.dtype != torch.float32:
        return d, fail
    floor = 1e-6 * _rows_max_abs(diag)
    d2, fail2 = solve(torch.maximum(lam, floor))
    return torch.where(fail[:, None], d2, d), fail & fail2


def damped_spd_solve(jtj, lam, b, spd=spd_solve):
    """``spd(jtj + lam*I, b)`` per lane with an f32 singular-rescue retry,
    for a dense ``jtj`` (B, n, n).

    In f64 this is one plain factorization (reference-exact). In f32 a
    lane whose factorization FAILS with the raw lambda is re-factored with
    lambda floored at ``1e-6 * max|diag|`` (just above f32 round-off for the
    matrix's scale); well-conditioned lanes keep the exact damping. The
    carried lambda is untouched either way (``ezpz_tpu/solver.py:176-202``).
    ``lam`` is (B,); ``spd`` is the normal-equation solver (``spd_solve``'s
    contract: ``(x, fail)``, x zero-filled on failed lanes). The band tier
    takes ``damped_band_solve`` instead."""
    with tracing.span("ezpz.lm.damped_solve"):
        eye = torch.eye(jtj.shape[-1], dtype=jtj.dtype, device=jtj.device)
        return _rescued(lambda lam_: spd(jtj + lam_[:, None, None] * eye, b), lam,
                        torch.diagonal(jtj, dim1=-2, dim2=-1))


def damped_band_solve(band, lam, b, route: BandRoute):
    """``damped_spd_solve``'s contract for a JtJ held in the lower band
    ``band`` (B, n, bw+1) of the route ``route`` (``normal_equations(...,
    band=route)``): lambda is added to the band's diagonal column alone, the
    values the dense route's factor sees (its ``lam * I`` adds exact zeros
    off the diagonal), the f32 retry is the same, and the band is solved by
    ``route.solve`` (b into the route's ordering, x back).

    A band that ``route.damps_in_one_launch`` (on the card, on the lane
    kernel's route) is solved in one launch: the kernel damps the diagonal
    as it loads it and re-solves only the lanes whose factor failed
    (``lm.band_damped`` counts these launches). Any other band takes
    ``damped_band_composed``, the answer that launch is held to bit for
    bit."""
    with tracing.span("ezpz.lm.damped_solve"):
        if route.damps_in_one_launch(band):
            tracing.count("lm.band_damped")
            return route.solve(band, b, lam=lam)
        return damped_band_composed(band, lam, b, route)


def damped_band_composed(band, lam, b, route: BandRoute):
    """``damped_band_solve`` composed of undamped solves: a copy of the
    band with lambda added to its diagonal column, solved by
    ``route.solve``, and ``_rescued``'s f32 retry on a second copy."""
    bw = band.shape[-1] - 1

    def solve(lam_):
        damped = band.clone()
        damped[..., bw] += lam_[:, None]
        return route.solve(damped, b)

    return _rescued(solve, lam, band[..., bw])


def _damped_step(system: CompiledSystem, x, lam, spd, pars=None, rhs=None):
    """The LM step ``-(JtJ + lam I)^-1 Jtr`` at ``x`` (B, n) by ``spd``:
    ``(d, fail, degenerate flags)``. A band route (``ops.banded.BandRoute``,
    from ``batch._pick_spd``) keeps JtJ in its band from assembly to
    factor; any other ``spd`` takes the dense JtJ. ``pars`` and ``rhs``
    go to ``normal_equations``."""
    band = spd if isinstance(spd, BandRoute) else None
    _r, jtj, jtr, deg = system.normal_equations(x, pars, rhs=rhs, band=band)
    if band is None:
        d, fail = damped_spd_solve(jtj, lam, -jtr, spd=spd)
    else:
        d, fail = damped_band_solve(jtj, lam, -jtr, band)
    return d, fail, deg


def solve_lm(system: CompiledSystem, x0: torch.Tensor, max_iterations: int,
             residual_tolerance, step_tolerance, initial_lambda, pars=None,
             debug_jac: bool = False, spd=spd_solve) -> LMResult:
    """Run the LM loop on a batch ``x0`` (B, n) of one topology.
    ``residual_tolerance`` and ``step_tolerance`` are scalars or per-lane
    (B,) tensors; ``pars`` optionally overrides the per-block parameters
    with (B, n_k, p_k) tensors. ``debug_jac`` prints the dense weighted
    Jacobian of every live lane on every trip (the reference's ``dbg-jac``
    feature, ``solver.rs:370-439``). ``spd`` solves the damped normal
    equations (``_damped_step``)."""
    dtype = system.dtype
    dev = x0.device
    rtol = to_device(residual_tolerance, dtype=dtype, device=dev)
    stol = to_device(step_tolerance, dtype=dtype, device=dev)
    state = _init_state(system, x0, initial_lambda, pars=pars)

    def step(s: LMState, _live):
        return _damped_step(system, s.x, s.lam, spd, pars)

    debug_fn = None
    if debug_jac:
        def debug_fn(s: LMState, live):
            J = system.jacobian_dense(s.x, pars).cpu().numpy()
            its = s.it.cpu().numpy()
            for b in torch.nonzero(live).flatten().tolist():
                print(f"dbg-jac: iteration {its[b]}, dense Jacobian =\n{J[b]}",
                      flush=True)

    final, res_conv = _lm_while_loop(
        state, lambda x: system.residual_and_flags(x, pars), step,
        max_iterations, rtol, stol, boundary_parity=True, debug_fn=debug_fn)
    return _reference_result(final, res_conv, max_iterations)


def solve_gauss_newton(system: CompiledSystem, x0: torch.Tensor,
                       max_iterations: int, residual_tolerance, step_tolerance,
                       initial_lambda, pars=None) -> LMResult:
    """Damped Gauss-Newton with a fixed damping ``initial_lambda`` over a
    batch ``x0`` (B, n): the reference's variant kept beside LM
    (``newton.rs:150-228``). No accept/reject: every step is taken.

    Per lane, as the JAX package's loop: a trip evaluates the residual and
    normal equations at x; residual convergence (``max|r| <= rtol``) ends
    the lane without advancing its count; otherwise the damped step is
    taken, unless its factorization failed (then x stays and the trip
    cannot count as step convergence), and ``max|d| <= stol`` ends the lane
    at that trip's index. The budget is strict (``it < max_iterations``).
    The final residual and degenerate flags are evaluated once, after the
    loop."""
    dtype = system.dtype
    x = x0.to(dtype)
    B = x.shape[0]
    dev = x.device
    lam = torch.full((B,), initial_lambda, dtype=dtype, device=dev)
    rtol = to_device(residual_tolerance, dtype=dtype, device=dev)
    stol = to_device(step_tolerance, dtype=dtype, device=dev)
    it = torch.zeros((B,), dtype=torch.int32, device=dev)
    iterations = it
    done = torch.zeros((B,), dtype=torch.bool, device=dev)  # = converged
    deg = torch.zeros((B, system.n_constraints), dtype=torch.bool, device=dev)
    while True:
        live = ~done & (it < max_iterations)
        if not bool(live.any()):
            break
        r, jtj, jtr, deg_j = system.normal_equations(x, pars)
        res_conv = _rows_max_abs(r) <= rtol
        act = ~res_conv
        d, fail = damped_spd_solve(jtj, lam, -jtr)
        step_conv = act & ~fail & (_rows_max_abs(d) <= stol)
        now = res_conv | step_conv
        keep = live[:, None]
        x = torch.where(keep & (act & ~fail)[:, None], x + d, x)
        deg = deg | (deg_j & act[:, None] & keep)
        iterations = torch.where(live & now, it, iterations)
        done = done | (live & now)
        it = torch.where(live & act, it + 1, it)
    iterations = torch.where(done, iterations, torch.full_like(it, max_iterations))
    r_final, deg_f = system.residual_and_flags(x, pars)
    return LMResult(x=x, iterations=iterations, converged=done,
                    deg=deg | deg_f, residual=r_final)


def _cg(matvec, b: torch.Tensor, x0, tol, max_iters, minv_diag=None) -> torch.Tensor:
    """Conjugate gradients on an SPD operator, on every lane of ``b`` (B,
    n): ``matvec`` maps (B, n) to (B, n); ``x0`` (B, n) is the start (r0 =
    b - A x0), ``None`` for zeros (r0 = b); ``tol`` (the absolute tolerance
    on a lane's residual norm) and ``max_iters`` are scalars or per-lane
    (B,) tensors. ``minv_diag`` (B, n), when given, is the Jacobi
    preconditioner's elementwise inverse (the JAX package's ``_pcg``).

    Each lane stops where its own ``lax.while_loop`` would (``|r|^2 >
    tol^2`` and fewer than ``max_iters`` trips, both strict): a trip
    computes every lane and keeps the new state only on the lanes still
    running, as ``vmap`` of the JAX loop does. One host sync per trip."""
    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x, r = x0, b - matvec(x0)
    z = r if minv_diag is None else minv_diag * r
    p = z
    rz = torch.sum(r * z, dim=-1)
    it = torch.zeros(b.shape[:-1], dtype=torch.int32, device=b.device)
    while True:
        rs = rz if minv_diag is None else torch.sum(r * r, dim=-1)
        live = (rs > tol * tol) & (it < max_iters)
        if not bool(live.any()):
            return x
        ap = matvec(p)
        alpha = rz / torch.sum(p * ap, dim=-1)
        x_n = x + alpha[:, None] * p
        r_n = r - alpha[:, None] * ap
        z_n = r_n if minv_diag is None else minv_diag * r_n
        rz_n = torch.sum(r_n * z_n, dim=-1)
        p_n = z_n + (rz_n / rz)[:, None] * p
        keep = live[:, None]
        x, r, p = (torch.where(keep, a, c) for a, c in ((x_n, x), (r_n, r), (p_n, p)))
        rz = torch.where(live, rz_n, rz)
        it = torch.where(live, it + 1, it)


def solve_lm_cg(system: CompiledSystem, x0: torch.Tensor, max_iterations: int,
                residual_tolerance, step_tolerance, initial_lambda, pars=None,
                cg_tol: float = 1e-12, cg_max_iters: int = 400) -> LMResult:
    """LM with a matrix-free conjugate-gradient step, over a batch ``x0``
    (B, n): ``(JtJ + lambda I) d = -Jt r`` is solved by ``_cg`` with
    ``jtj_matvec`` on the per-block Jacobian factors (O(nnz) per trip), so
    the dense (B, n, n) JtJ is never formed. lambda > 0 keeps the operator
    SPD, so there is no factorization-failure path; everything else is
    ``solve_lm``'s. A lane the loop does not step gets a CG budget of 0
    (its step would be discarded)."""
    dtype = system.dtype
    dev = x0.device
    rtol = to_device(residual_tolerance, dtype=dtype, device=dev)
    stol = to_device(step_tolerance, dtype=dtype, device=dev)
    state = _init_state(system, x0, initial_lambda, pars=pars)

    def step(s: LMState, live):
        _r, jtr, wjacs, deg_j = system.jacobian_factors(s.x, pars)
        lam = s.lam[:, None]
        budget = torch.where(live, cg_max_iters, 0)
        d = _cg(lambda v: system.jtj_matvec(wjacs, v) + lam * v, -jtr,
                torch.zeros_like(s.x), cg_tol, budget)
        return d, torch.zeros_like(s.done), deg_j

    final, res_conv = _lm_while_loop(
        state, lambda x: system.residual_and_flags(x, pars), step,
        max_iterations, rtol, stol, boundary_parity=True)
    return _reference_result(final, res_conv, max_iterations)


def solve_lm_mixed(system64: CompiledSystem, system32: CompiledSystem,
                   x0: torch.Tensor, max_iterations: int, residual_tolerance,
                   step_tolerance, initial_lambda, pars64=None,
                   pars32=None, spd=spd_solve) -> LMResult:
    """Mixed-precision LM: f32 iterations, then f64-residual refinement.

    Phase 1 runs ``solve_lm`` on the f32 twin, at most
    ``COARSE_MAX_ITERATIONS`` trips, toward ``COARSE_TOLERANCE`` and the
    step floor ``1e-7``, both scaled per lane by ``max(1, |x0|_inf)``
    (f32 round-off on residuals scales with coordinate magnitude). Phase 2
    is ``solve_lm_refine``. ``iterations`` counts both phases; both factor
    with ``spd``."""
    f32 = system32.dtype
    scale = torch.maximum(torch.ones((), dtype=f32, device=x0.device),
                          _rows_max_abs(x0).to(f32))
    coarse = solve_lm(
        system32, x0.to(f32), min(max_iterations, COARSE_MAX_ITERATIONS),
        to_device(COARSE_TOLERANCE, dtype=f32, device=x0.device) * scale,
        torch.maximum(to_device(step_tolerance, dtype=f32, device=x0.device),
                      1e-7 * scale),
        initial_lambda, pars=pars32, spd=spd)
    return solve_lm_refine(
        system64, system32, coarse.x, coarse.iterations, coarse.deg,
        max_iterations, residual_tolerance, step_tolerance, initial_lambda,
        pars64=pars64, pars32=pars32, spd=spd)


def solve_lm_refine(system64: CompiledSystem, system32: CompiledSystem,
                    x_coarse: torch.Tensor, coarse_iterations, coarse_deg,
                    max_iterations: int, residual_tolerance, step_tolerance,
                    initial_lambda, pars64=None, pars32=None,
                    spd=spd_solve) -> LMResult:
    """The f64-residual refinement: from a coarse point (B, n), its
    iteration counts (B,) and degenerate flags (B, n_cons), run LM trips
    whose residual and accept/reject are f64 while the Jacobian, normal
    equations and factorization (by ``spd``) stay f32. Lambda restarts at
    ``initial_lambda`` in f32. Each lane's budget is
    ``clip(max_iterations - coarse_iterations, 0, REFINE_ITERATIONS)``;
    reported iterations include the coarse count."""
    f64 = system64.dtype
    dev = x_coarse.device
    rtol = to_device(residual_tolerance, dtype=f64, device=dev)
    stol = to_device(step_tolerance, dtype=f64, device=dev)
    coarse_iterations = to_device(coarse_iterations, dtype=torch.int32, device=dev)
    refine_limit = torch.clamp(max_iterations - coarse_iterations, 0, REFINE_ITERATIONS)
    state = _init_state(system64, x_coarse, initial_lambda,
                        lam_dtype=system32.dtype, pars=pars64,
                        deg_extra=coarse_deg)

    def step(s: LMState, _live):
        # The f32 twin's Jacobian at x cast, against the f64 residual cast.
        d32, fail, deg_j = _damped_step(system32, s.x, s.lam, spd, pars32, rhs=s.r)
        return d32.to(f64), fail, deg_j

    final, res_conv = _lm_while_loop(
        state, lambda x: system64.residual_and_flags(x, pars64), step,
        refine_limit, rtol, stol, boundary_parity=False)
    refine_count = torch.where(
        final.done, final.iterations,
        torch.where(res_conv, final.it, refine_limit))
    return LMResult(x=final.x, iterations=coarse_iterations + refine_count,
                    converged=final.done | res_conv, deg=final.deg,
                    residual=final.r)


def make_solver(system: CompiledSystem, max_iterations: int,
                precision: str = "f64", device=None):
    """A solver for one compiled topology on ``device`` (the card unless
    the caller names another): ``run(x0, residual_tolerance,
    step_tolerance, initial_lambda)`` solves one sketch from ``x0``
    (n_vars,) as a batch of one lane.

    ``precision="mixed"`` swaps ``solve_lm`` for ``solve_lm_mixed`` (f32
    trips, then the f64-residual refinement; iteration counts are then not
    the reference's). ``EZPZ_TPU_DBG_JAC=1`` (read here) makes the f64
    loop print the dense Jacobian on every trip.

    ``run`` returns ONE packed 1-D f64 tensor on the device, ``[x (n_vars)
    | sat (n_cons) | deg (n_cons) | converged | iterations]``, so the
    caller makes one device-to-host copy per solve. Unpack its host copy
    with ``unpack_solver_result``."""
    if precision not in ("f64", "mixed"):
        raise ValueError(f"precision must be 'f64' or 'mixed', got {precision!r}")
    dev = resolve_device(device)
    debug_jac = os.environ.get("EZPZ_TPU_DBG_JAC", "") not in ("", "0")
    system32 = system.astype(torch.float32) if precision == "mixed" else None

    def run(x0, residual_tolerance, step_tolerance, initial_lambda):
        x = to_device(x0, dtype=torch.float64, device=dev)[None]
        args = (max_iterations, residual_tolerance, step_tolerance, initial_lambda)
        if system32 is not None:
            res = solve_lm_mixed(system, system32, x, *args)
        else:
            res = solve_lm(system, x, *args, debug_jac=debug_jac)
        sat = system.satisfaction(res.x, res.residual)
        return pack_result(res.x[0], sat[0], res.deg[0], res.converged[0],
                           res.iterations[0])

    return run


def pack_result(x, sat, deg, converged, iterations) -> torch.Tensor:
    """``[x | sat | deg | converged | iterations]`` as one f64 tensor on
    ``x``'s device (the layout ``unpack_solver_result`` splits)."""
    dt = x.dtype
    return torch.cat([x, sat.to(dt), deg.to(dt),
                      torch.stack([converged.to(dt), iterations.to(dt)])])


def unpack_solver_result(packed: np.ndarray, n_vars: int, n_cons: int):
    """Split the host copy of a packed solver result back into ``(x, sat,
    deg, converged, iterations)`` (numpy views and Python scalars)."""
    x = packed[:n_vars]
    sat = packed[n_vars:n_vars + n_cons] != 0.0
    deg = packed[n_vars + n_cons:n_vars + 2 * n_cons] != 0.0
    converged = bool(packed[n_vars + 2 * n_cons])
    iterations = int(packed[n_vars + 2 * n_cons + 1])
    return x, sat, deg, converged, iterations
