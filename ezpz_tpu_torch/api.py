"""Public solve API: priority cascade, validation, satisfaction, warnings.

The PyTorch counterpart of ``ezpz_tpu/api.py``, which mirrors
``ezpz/src/lib.rs``:

* ``solve(reqs, initial_guesses, config)`` — the priority cascade solves the
  highest-priority subset first, then keeps adding lower tiers until a tier
  fails or leaves constraints unsatisfied, returning the last fully-satisfied
  tier's solution (``lib.rs:199-246``). Each tier restarts from the original
  guesses.
* Undefined tangency sides are inferred from the initial values before
  solving (``lib.rs:183-186``).
* After the LM loop, every constraint is re-checked unweighted against
  ``EPSILON = 1e-4`` (``lib.rs:307-327``).
* Degenerate geometry produces warnings, not errors; non-convergence returns
  ``converged = False``.

Every entry point takes ``device``: ``None`` means the card (``"cuda"``),
and on a machine without one it raises; ``device="cpu"`` solves on the
CPU. A solve makes one device-to-host copy, of the packed outcome.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Config
from .constraints import ConstraintRequest
from .dof import freedom_analysis
from .models.blocks import BlockProgram, connected_components
from .models.compiled import compile_system, topology_key
from .outcomes import (
    FailureOutcome,
    FreedomAnalysis,
    SolveOutcome,
    SolveOutcomeFreedomAnalysis,
)
from .solver import make_solver, resolve_device, unpack_solver_result
from .utils.errors import MissingGuess, NotFound, WrongNumberGuesses
from .utils.ids import Id
from .utils.warnings import Warning, WarningKind, lint

# Solvers keyed by compiled topology and device, so repeated solves of the
# same sketch (priority tiers, the CLI's timing loop, tests) build their
# compiled system and buckets once. LRU: dicts iterate in insertion order,
# so evicting the first key drops the least-recently-used entry (hits
# re-insert).
_SOLVER_CACHE: Dict[tuple, tuple] = {}
_SOLVER_CACHE_LIMIT = 256

# Sketches that decompose into at least this many independent components
# take the decomposed path (models.blocks.BlockProgram): one batched LM per
# topology bucket instead of one monolithic dense LM. Below the threshold
# the reference-exact global loop runs (identical damping schedule and
# iteration counts). EZPZ_TPU_DECOMPOSE_MIN overrides (the JAX package's
# variable, so one setting steers both); 0 disables decomposition.
_DECOMPOSE_MIN_DEFAULT = 32


def _decompose_min() -> int:
    raw = os.environ.get("EZPZ_TPU_DECOMPOSE_MIN", "")
    try:
        return int(raw) if raw else _DECOMPOSE_MIN_DEFAULT
    except ValueError:
        return _DECOMPOSE_MIN_DEFAULT


def _validate_and_densify(
    entries: Sequence[Tuple[int, ConstraintRequest]],
    initial_guesses: Sequence[Tuple[Id, float]],
) -> np.ndarray:
    """Check every referenced variable has a guess (``solver.rs:142-189``)
    and build the flat variable vector indexed by id."""
    ids = [g[0] for g in initial_guesses]
    id_set = set(ids)
    if len(id_set) != len(ids):
        raise WrongNumberGuesses(labels=len(id_set), guesses=len(ids))
    n = len(ids)
    for vid in ids:
        if not (0 <= vid < n):
            raise NotFound(vid)
    for cid, req in entries:
        for vid in req.constraint.dependent_variable_ids():
            if vid not in id_set:
                raise MissingGuess(constraint_id=cid, variable=vid)
    x = np.zeros(n, dtype=np.float64)
    for vid, val in initial_guesses:
        x[vid] = val
    return x


def _get_system_and_solver(constraints, weights, n_vars: int,
                           max_iterations: int, precision: str = "f64",
                           device=None):
    """Compiled system + solver for this topology on ``device``, LRU-cached.

    ``topology_key`` covers kernel ids, variable indices AND parameter
    values, so a hit safely reuses the cached system too. The key holds
    the device: a solver built for one device never serves another.

    Returns either ``(CompiledSystem, make_solver(...))`` or
    ``(BlockProgram, its solver)``: both expose ``n_vars`` and the same
    packed solver contract, so callers are path-agnostic."""
    if precision not in ("f64", "mixed"):
        raise ValueError(
            f"precision must be 'f64' or 'mixed', got {precision!r}")
    dev = resolve_device(device)
    thresh = _decompose_min()
    dbg = os.environ.get("EZPZ_TPU_DBG_JAC", "")
    key = (
        topology_key(constraints, n_vars),
        tuple(weights),
        max_iterations,
        dbg,  # make_solver reads it
        thresh,
        precision,
        str(dev),
    )
    hit = _SOLVER_CACHE.pop(key, None)
    if hit is not None:
        _SOLVER_CACHE[key] = hit  # re-insert: now most-recently-used
        return hit

    system = solver = None
    # dbg-jac prints the whole system's dense Jacobian per trip: it stays
    # on the monolithic path, where that Jacobian exists.
    if thresh > 0 and dbg in ("", "0") and len(constraints) >= thresh:
        if len(connected_components(constraints, n_vars)) >= thresh:
            program = BlockProgram(
                constraints, n_vars, list(weights), max_iterations,
                precision=precision, device=dev,
            )
            if program.complete and program.n_components >= thresh:
                system, solver = program, program.solver
    if system is None:
        system = compile_system(constraints, n_vars=n_vars, weights=weights)
        solver = make_solver(system, max_iterations, precision=precision, device=dev)
    while len(_SOLVER_CACHE) >= _SOLVER_CACHE_LIMIT:
        _SOLVER_CACHE.pop(next(iter(_SOLVER_CACHE)))  # evict oldest only
    _SOLVER_CACHE[key] = (system, solver)
    return system, solver


def _num_eqs(entries) -> int:
    return sum(req.constraint.residual_dim() for _cid, req in entries)


def _dispatch_solve(
    entries: Sequence[Tuple[int, ConstraintRequest]],
    initial_guesses: Sequence[Tuple[Id, float]],
    config: Config,
    device,
):
    """The host-side half of one tier's solve: lint, validate, build (or
    hit the solver cache) and run the solver, leaving its packed result on
    the device. Returns ``(packed_device_tensor, system, warnings)``."""
    warnings: List[Warning] = lint([(cid, req.constraint) for cid, req in entries])

    try:
        x0 = _validate_and_densify(entries, initial_guesses)
    except Exception as error:  # typed errors from validation
        raise FailureOutcome(
            error=error, warnings=warnings, num_vars=len(initial_guesses),
            num_eqs=_num_eqs(entries),
        ) from None

    constraints = [req.constraint for _cid, req in entries]
    weights = [req.weight for _cid, req in entries]
    system, solver = _get_system_and_solver(
        constraints, weights, len(x0), config.max_iterations, config.precision,
        device,
    )
    packed = solver(
        x0, config.residual_tolerance, config.step_tolerance, config.initial_lambda
    )
    return packed, system, warnings


def _solve_inner(
    entries: Sequence[Tuple[int, ConstraintRequest]],
    initial_guesses: Sequence[Tuple[Id, float]],
    config: Config,
    want_analysis: bool,
    device,
) -> Tuple[Optional[FreedomAnalysis], SolveOutcome]:
    packed, system, warnings = _dispatch_solve(entries, initial_guesses, config, device)
    # ONE device-to-host copy for the whole outcome.
    x_final, sat, deg, converged, iterations = unpack_solver_result(
        packed.cpu().numpy(), system.n_vars, len(entries)
    )

    # One degenerate warning per flagged constraint (the reference pushes a
    # warning per evaluation and can duplicate; this deduplicates).
    for local_idx, flagged in enumerate(deg):
        if flagged:
            warnings.append(
                Warning(about_constraint=entries[local_idx][0], content=WarningKind.DEGENERATE)
            )

    unsatisfied = [entries[i][0] for i in range(len(entries)) if not sat[i]]

    analysis: Optional[FreedomAnalysis] = None
    if want_analysis:
        try:
            if isinstance(system, BlockProgram):
                # Per-bucket batched SVDs with the same global thresholds
                # (exact: the Jacobian is block-diagonal up to a
                # permutation).
                analysis = system.freedom_analysis(x_final)
            else:
                x = torch.as_tensor(x_final, device=packed.device)[None]
                analysis = freedom_analysis(system.jacobian_dense(x)[0].cpu().numpy())
        except Exception as error:
            raise FailureOutcome(
                error=error, warnings=warnings, num_vars=len(initial_guesses),
                num_eqs=_num_eqs(entries),
            ) from None

    priority_solved = max((req.priority for _cid, req in entries), default=0)
    outcome = SolveOutcome(
        unsatisfied=unsatisfied,
        converged=converged,
        final_values=[float(v) for v in x_final],
        iterations=iterations,
        warnings=warnings,
        priority_solved=priority_solved,
    )
    return analysis, outcome


def _resolve_entries(
    reqs: Sequence[ConstraintRequest],
    initial_guesses: Sequence[Tuple[Id, float]],
) -> List[Tuple[int, ConstraintRequest]]:
    """Tangency-side inference from the initial values (``lib.rs:172-186``),
    preserving each request's original index. A request whose side does
    not resolve is kept as the same object, so its per-constraint memos
    (lowering, topology fragment) survive re-solves."""
    max_id = max((vid for vid, _ in initial_guesses), default=0)
    dense = [0.0] * (max_id + 1)
    for vid, val in initial_guesses:
        dense[vid] = val
    resolved = []
    for r in reqs:
        c = r.constraint.set_from_initial_values(dense)
        if c is r.constraint:
            resolved.append(r)
        else:
            resolved.append(ConstraintRequest(
                constraint=c, priority=r.priority, weight=r.weight))
    return list(enumerate(resolved))


def _tiers(entries):
    """The cascade's subsets: every request up to each priority, in order."""
    for curr_max in sorted({req.priority for _cid, req in entries}):
        yield [(cid, req) for cid, req in entries if req.priority <= curr_max]


def _solve_with_priority(
    reqs: Sequence[ConstraintRequest],
    initial_guesses: Sequence[Tuple[Id, float]],
    config: Config,
    want_analysis: bool,
    device=None,
) -> Tuple[Optional[FreedomAnalysis], SolveOutcome]:
    device = resolve_device(device)
    initial_guesses = list(initial_guesses)
    if not reqs:
        return (
            FreedomAnalysis([]) if want_analysis else None,
            SolveOutcome(
                unsatisfied=[],
                converged=True,
                final_values=[val for _id, val in initial_guesses],
                iterations=0,
                warnings=[],
                priority_solved=0,
            ),
        )

    best: Optional[Tuple[Optional[FreedomAnalysis], SolveOutcome]] = None
    for subset in _tiers(_resolve_entries(reqs, initial_guesses)):
        try:
            result = _solve_inner(subset, initial_guesses, config, want_analysis, device)
        except FailureOutcome:
            if best is not None:
                return best
            raise
        if result[1].is_unsatisfied():
            return best if best is not None else result
        best = result
    assert best is not None
    return best


def solve(
    reqs: Sequence[ConstraintRequest],
    initial_guesses: Sequence[Tuple[Id, float]],
    config: Config = Config(),
    device=None,
) -> SolveOutcome:
    """Solve the constraint system on ``device`` (the card unless the
    caller names another). Raises ``FailureOutcome`` on definition errors;
    returns ``converged=False`` (not an error) when LM stalls.

    The reference's doctest (``ezpz/src/lib.rs:47-87``): pin p at the
    origin, require q to be 4 away, start q near (4.39, 4.38):

    >>> import ezpz_tpu_torch as ez
    >>> ids = ez.IdGenerator()
    >>> p, q = ez.DatumPoint.new(ids), ez.DatumPoint.new(ids)
    >>> reqs = [ez.ConstraintRequest.highest_priority(c) for c in [
    ...     ez.Constraint.Fixed(p.id_x(), 0.0),
    ...     ez.Constraint.Fixed(p.id_y(), 0.0),
    ...     ez.Constraint.Distance(p, q, 4.0)]]
    >>> out = ez.solve(reqs, [(p.id_x(), 0.0), (p.id_y(), -0.02),
    ...                       (q.id_x(), 4.39), (q.id_y(), 4.38)], device="cpu")
    >>> out.converged
    True
    >>> qx, qy = out.final_values[2], out.final_values[3]
    >>> round((qx ** 2 + qy ** 2) ** 0.5, 6)   # |q - p| == 4
    4.0
    """
    _analysis, outcome = _solve_with_priority(reqs, initial_guesses, config, False,
                                              device)
    return outcome


def time_resolves(
    reqs: Sequence[ConstraintRequest],
    initial_guesses: Sequence[Tuple[Id, float]],
    config: Config = Config(),
    iters: int = 100,
    pipelined: bool = False,
    device=None,
) -> float:
    """Mean seconds per re-solve over ``iters`` repeats on ``device`` — the
    reference CLI's micro-benchmark protocol (``ezpz-cli/src/main.rs:96-100``).

    ``pipelined=False``: strictly synchronous — every solve's outcome is
    copied to the host before the next begins.

    ``pipelined=True``: every re-solve's host path (lint, validation,
    solver-cache lookup, solve) runs per iteration, the device is
    synchronized ONCE at the end and only the last outcome is copied to the
    host. The executed priority tiers are recorded from one untimed cascade
    first (re-solves of identical input run the same tiers). The port's LM
    loop reads one flag per trip on the host, so a solve waits for the
    device inside its loop and the two protocols measure nearly the same
    work."""
    device = resolve_device(device)
    if not pipelined:
        t0 = time.perf_counter()
        for _ in range(iters):
            solve(reqs, initial_guesses, config, device=device)
        return (time.perf_counter() - t0) / iters

    initial_guesses = list(initial_guesses)
    # Untimed replay of the cascade to record which tier subsets execute.
    executed: List[List[Tuple[int, ConstraintRequest]]] = []
    for subset in _tiers(_resolve_entries(reqs, initial_guesses)):
        executed.append(subset)
        try:
            result = _solve_inner(subset, initial_guesses, config, False, device)
        except FailureOutcome:
            break
        if result[1].is_unsatisfied():
            break

    t0 = time.perf_counter()
    packed = None
    for _ in range(iters):
        for subset in executed:
            packed, _system, _warnings = _dispatch_solve(
                subset, initial_guesses, config, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # Copy one outcome so a full solve's host conversion is paid at least
    # once inside the timed region.
    if packed is not None:
        packed.cpu().numpy()
    return (time.perf_counter() - t0) / iters


def solve_analysis(
    reqs: Sequence[ConstraintRequest],
    initial_guesses: Sequence[Tuple[Id, float]],
    config: Config = Config(),
    device=None,
) -> SolveOutcomeFreedomAnalysis:
    """Like ``solve`` but also runs the (expensive) degrees-of-freedom
    analysis. Call on structure changes, not every value tweak."""
    analysis, outcome = _solve_with_priority(reqs, initial_guesses, config, True,
                                             device)
    assert analysis is not None
    return SolveOutcomeFreedomAnalysis(analysis=analysis, outcome=outcome)
