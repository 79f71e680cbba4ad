"""The plain reference: Levenberg-Marquardt in NumPy and SciPy for the four
constraint kinds the benchmark's sketches use.

It follows the upstream solver's semantics (KittyCAD/ezpz ``solver.rs``,
``lib.rs``): the residual of each constraint, an LM loop that stops when
every residual row is within ``residual_tolerance`` or a step is within
``step_tolerance``, and a constraint counted satisfied when its residual is
below 1e-4. It imports nothing of the program: it takes the benchmark's
plain constraint data, the parameters and the guesses, and works out the
Jacobian, the normal equations and the answer itself, one sketch at a
time, with a sparse factorization.

A sketch's constraints are rows of ``kinds`` (the codes below) and ``ids``
(four variable ids a row; a point is ``(x id, y id)``):

* ``FIXED``: ``x[ids[0]] - param``;
* ``HORIZONTAL``: the points ``(ids[0], ids[1])`` and ``(ids[2], ids[3])``
  at one height, ``y_p - y_q``;
* ``VERTICAL``: the same points on one vertical, ``x_p - x_q``;
* ``DISTANCE``: ``|p - q| - param``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spl

FIXED, HORIZONTAL, VERTICAL, DISTANCE = 0, 1, 2, 3

# ezpz/src/lib.rs:43 and solver.rs:72-80.
SATISFIED_BELOW = 1e-4
RESIDUAL_TOLERANCE = 1e-8
STEP_TOLERANCE = 1e-12
MAX_ITERATIONS = 35
INITIAL_LAMBDA = 1e-9


@dataclass(frozen=True)
class Sketch:
    """One sketch as plain data: ``kinds`` (m,) codes, ``ids`` (m, 4)
    variable ids (unused slots 0), ``params`` (m,) (0 where a kind has
    none) and ``guess`` (n_vars,)."""

    kinds: np.ndarray
    ids: np.ndarray
    params: np.ndarray
    guess: np.ndarray

    @property
    def n_vars(self) -> int:
        return int(self.guess.shape[0])

    @property
    def n_constraints(self) -> int:
        return int(self.kinds.shape[0])


@dataclass(frozen=True)
class Answer:
    x: np.ndarray  # (n_vars,)
    converged: bool
    satisfied: np.ndarray  # (m,) bool

    @property
    def solved(self) -> bool:
        return bool(self.converged and self.satisfied.all())


def residual(kinds, ids, params, x):
    """The residual rows (m,) at ``x``, in ``x``'s dtype."""
    a, b, c, d = (x[ids[:, k]] for k in range(4))
    dist = np.sqrt((a - c) ** 2 + (b - d) ** 2)
    return np.select([kinds == FIXED, kinds == HORIZONTAL, kinds == VERTICAL],
                     [a - params, b - d, a - c], dist - params).astype(x.dtype)


def jacobian(kinds, ids, x):
    """The sparse Jacobian (m, n) at ``x``."""
    m = kinds.shape[0]
    rows, cols, vals = [], [], []

    def add(mask, slot, value):
        r = np.nonzero(mask)[0]
        rows.append(r)
        cols.append(ids[r, slot])
        vals.append(np.broadcast_to(np.asarray(value, dtype=x.dtype), r.shape)
                    if np.ndim(value) == 0 else value[r])

    add(kinds == FIXED, 0, 1.0)
    add(kinds == HORIZONTAL, 1, 1.0)
    add(kinds == HORIZONTAL, 3, -1.0)
    add(kinds == VERTICAL, 0, 1.0)
    add(kinds == VERTICAL, 2, -1.0)
    a, b, c, d = (x[ids[:, k]] for k in range(4))
    dist = np.sqrt((a - c) ** 2 + (b - d) ** 2)
    dist = np.where(dist > 0, dist, 1).astype(x.dtype)
    ux, uy = (a - c) / dist, (b - d) / dist
    on = kinds == DISTANCE
    add(on, 0, ux)
    add(on, 1, uy)
    add(on, 2, -ux)
    add(on, 3, -uy)
    return sp.csr_matrix((np.concatenate(vals).astype(x.dtype),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(m, x.shape[0]))


def solve(sketch: Sketch, params=None, guess=None, dtype=np.float64) -> Answer:
    """Solve one sketch from ``guess`` (default the sketch's) with
    ``params`` (default the sketch's), every step in ``dtype``."""
    kinds, ids = sketch.kinds, sketch.ids
    p = np.asarray(sketch.params if params is None else params, dtype=dtype)
    x = np.asarray(sketch.guess if guess is None else guess, dtype=dtype).copy()
    r = residual(kinds, ids, p, x)
    cost = r @ r
    lam = dtype(INITIAL_LAMBDA)
    eye = sp.identity(x.shape[0], dtype=dtype, format="csc")
    converged = False
    for _ in range(MAX_ITERATIONS):
        if np.max(np.abs(r), initial=0.0) <= RESIDUAL_TOLERANCE:
            converged = True
            break
        jac = jacobian(kinds, ids, x)
        step = spl.spsolve((jac.T @ jac).tocsc() + lam * eye, -(jac.T @ r))
        step = np.asarray(step, dtype=dtype)
        if not np.all(np.isfinite(step)):
            lam = lam * dtype(10)
            continue
        x_new = x + step
        r_new = residual(kinds, ids, p, x_new)
        cost_new = r_new @ r_new
        if cost_new < cost:
            x, r, cost, lam = x_new, r_new, cost_new, lam * dtype(0.1)
        else:
            lam = lam * dtype(10)
        if np.max(np.abs(step)) <= STEP_TOLERANCE:
            converged = True
            break
    return Answer(x=x.astype(np.float64), converged=converged,
                  satisfied=np.abs(r) < SATISFIED_BELOW)


def max_residual(sketch: Sketch, params, x) -> float:
    """The widest residual row of ``x`` in float64 (the program's answer
    judged by the reference's own residuals); infinite if one is not
    finite."""
    r = residual(sketch.kinds, sketch.ids, np.asarray(params, dtype=np.float64),
                 np.asarray(x, dtype=np.float64))
    return float(np.max(np.abs(r), initial=0.0)) if np.isfinite(r).all() else float("inf")
