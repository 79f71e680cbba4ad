"""Solve outcomes (``ezpz/src/solve_outcome.rs``, ``ezpz/src/analysis.rs``).

A copy of ``ezpz_tpu.outcomes``: the public API of both packages returns
the same outcome types.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from .datatypes import (
    Arc,
    Circle,
    DatumCircle,
    DatumCircularArc,
    DatumDistance,
    DatumPoint,
    Point,
)
from .utils.errors import NonLinearSystemError
from .utils.ids import Id
from .utils.warnings import Warning


@dataclass
class SolveOutcome:
    """Data from a successfully solved system."""

    unsatisfied: List[int]
    converged: bool
    final_values: List[float]
    iterations: int
    warnings: List[Warning]
    priority_solved: int

    def is_satisfied(self) -> bool:
        return not self.unsatisfied

    def is_unsatisfied(self) -> bool:
        return bool(self.unsatisfied)

    # -- lookups (final_values is ordered like the initial guesses; the
    #    guess order/id mapping is carried by the solve call) ----------------

    def final_value_scalar(self, id: Id) -> float:
        return self.final_values[id]

    def final_value_distance(self, distance: DatumDistance) -> float:
        return self.final_values[distance.id]

    def final_value_point(self, point: DatumPoint) -> Point:
        return Point(self.final_values[point.x_id], self.final_values[point.y_id])

    def final_value_arc(self, arc: DatumCircularArc) -> Arc:
        return Arc(
            a=self.final_value_point(arc.start),
            b=self.final_value_point(arc.end),
            center=self.final_value_point(arc.center),
        )

    def final_value_circle(self, circle: DatumCircle) -> Circle:
        return Circle(
            center=self.final_value_point(circle.center),
            radius=self.final_value_distance(circle.radius),
        )


@dataclass
class FailureOutcome(Exception):
    """Returned (raised) when the system could not be solved at all.
    Non-convergence is NOT a failure — it is ``converged = False``."""

    error: NonLinearSystemError
    warnings: List[Warning]
    num_vars: int
    num_eqs: int

    def __str__(self) -> str:
        return str(self.error)


@dataclass
class FreedomAnalysis:
    """Degrees-of-freedom analysis: which variables are underconstrained
    (``ezpz/src/analysis.rs:27-68``)."""

    underconstrained_vars: List[Id] = field(default_factory=list)

    def is_underconstrained(self) -> bool:
        return bool(self.underconstrained_vars)

    def underconstrained(self) -> List[Id]:
        return self.underconstrained_vars


@dataclass
class SolveOutcomeFreedomAnalysis:
    analysis: FreedomAnalysis
    outcome: SolveOutcome
