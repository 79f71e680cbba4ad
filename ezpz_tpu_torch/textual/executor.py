"""Executor: parsed Problem -> constraint system -> named solved geometry.

Mirrors ``ezpz/src/textual/executor.rs``. Variable layout (the flat solver
vector) is: all points ``[x, y]``, then all circles ``[cx, cy, r]``, then all
arcs ``[ax, ay, bx, by, cx, cy]`` in declaration order. Note: the reference's
``geometry_variables.rs:92`` computes arc offsets *ignoring* circle variables
while its output path includes them (``executor.rs:549``) — a latent
mixed-circle+arc indexing bug. We use the one consistent layout
(points, circles, arcs) everywhere.

A copy of ``ezpz_tpu.textual.executor`` on the port's solve API: every
solve method takes ``device`` (``None`` means the card, and raises on a
machine without one; ``device="cpu"`` solves on the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..api import _solve_with_priority, time_resolves
from ..api import solve as _solve
from ..config import Config
from ..constraints import Constraint, ConstraintRequest, LineSide
from ..datatypes import (
    AngleKind,
    Arc,
    Circle,
    Component,
    DatumCircle,
    DatumCircularArc,
    DatumDistance,
    DatumLineSegment,
    DatumPoint,
    Point,
)
from ..outcomes import FailureOutcome, FreedomAnalysis, SolveOutcome
from ..utils.errors import TextualMissingGuess, UndefinedPoint, UnusedGuesses
from ..utils.warnings import Warning
from .problem import Instruction, Label, Problem

VARS_PER_POINT = 2
VARS_PER_CIRCLE = 3
VARS_PER_ARC = 6


@dataclass
class ConstraintSystem:
    """A solvable system built from the textual format."""

    constraints: List[ConstraintRequest]
    initial_guesses: List[Tuple[int, float]]
    inner_points: List[Label]
    inner_circles: List[Label]
    inner_arcs: List[Label]
    inner_lines: List[Tuple[Label, Label]]

    # -- solving -------------------------------------------------------------

    def solve_no_metadata(self, config: Config = Config(), device=None) -> SolveOutcome:
        return _solve(self.constraints, self.initial_guesses, config, device=device)

    def solve(self, device=None) -> "Outcome":
        return self.solve_with_config(Config(), device=device)

    def solve_with_config(self, config: Config, device=None) -> "Outcome":
        _analysis, outcome = self._solve_inner(config, False, device)
        return outcome

    def time_resolves(self, config: Config = Config(), iters: int = 100,
                      pipelined: bool = False, device=None) -> float:
        """Mean seconds per re-solve (the CLI's 100x timing protocol);
        ``pipelined=True`` synchronizes once at the end — see
        ``ezpz_tpu_torch.api.time_resolves``."""
        return time_resolves(self.constraints, self.initial_guesses, config,
                             iters=iters, pipelined=pipelined, device=device)

    def solve_with_config_analysis(self, config: Config = Config(),
                                   device=None) -> "OutcomeAnalysis":
        analysis, outcome = self._solve_inner(config, True, device)
        assert analysis is not None
        return OutcomeAnalysis(analysis=analysis, outcome=outcome)

    def _solve_inner(self, config: Config, want_analysis: bool, device):
        num_vars = len(self.initial_guesses)
        num_eqs = sum(r.constraint.residual_dim() for r in self.constraints)
        analysis, so = _solve_with_priority(
            self.constraints, self.initial_guesses, config, want_analysis, device
        )
        fv = so.final_values

        points: Dict[str, Point] = {}
        for i, label in enumerate(self.inner_points):
            points[label] = Point(fv[2 * i], fv[2 * i + 1])
        start_of_circles = VARS_PER_POINT * len(self.inner_points)
        circles: Dict[str, Circle] = {}
        for i, label in enumerate(self.inner_circles):
            base = start_of_circles + VARS_PER_CIRCLE * i
            circles[label] = Circle(
                radius=fv[base + 2], center=Point(fv[base], fv[base + 1])
            )
        start_of_arcs = start_of_circles + VARS_PER_CIRCLE * len(self.inner_circles)
        arcs: Dict[str, Arc] = {}
        for i, label in enumerate(self.inner_arcs):
            base = start_of_arcs + VARS_PER_ARC * i
            arcs[label] = Arc(
                a=Point(fv[base], fv[base + 1]),
                b=Point(fv[base + 2], fv[base + 3]),
                center=Point(fv[base + 4], fv[base + 5]),
            )

        outcome = Outcome(
            unsatisfied=so.unsatisfied,
            iterations=so.iterations,
            warnings=so.warnings,
            points=points,
            circles=circles,
            arcs=arcs,
            lines=list(self.inner_lines),
            num_vars=num_vars,
            num_eqs=num_eqs,
            priority_solved=so.priority_solved,
            converged=so.converged,
            final_values=fv,
        )
        return analysis, outcome


@dataclass
class Outcome:
    """Outcome of solving a textual system (``executor.rs:588-613``)."""

    unsatisfied: List[int]
    iterations: int
    warnings: List[Warning]
    points: Dict[str, Point]
    circles: Dict[str, Circle]
    arcs: Dict[str, Arc]
    lines: List[Tuple[Label, Label]]
    num_vars: int
    num_eqs: int
    priority_solved: int
    converged: bool
    final_values: List[float] = field(default_factory=list)

    def get_point(self, label: str) -> Optional[Point]:
        return self.points.get(label)

    def get_circle(self, label: str) -> Optional[Circle]:
        return self.circles.get(label)

    def get_arc(self, label: str) -> Optional[Arc]:
        return self.arcs.get(label)

    def is_satisfied(self) -> bool:
        return not self.unsatisfied

    def is_unsatisfied(self) -> bool:
        return bool(self.unsatisfied)


@dataclass
class OutcomeAnalysis:
    analysis: FreedomAnalysis
    outcome: Outcome

    def get_point(self, label: str) -> Optional[Point]:
        return self.outcome.get_point(label)

    def get_circle(self, label: str) -> Optional[Circle]:
        return self.outcome.get_circle(label)

    def get_arc(self, label: str) -> Optional[Arc]:
        return self.outcome.get_arc(label)

    def is_satisfied(self) -> bool:
        return self.outcome.is_satisfied()

    def is_unsatisfied(self) -> bool:
        return self.outcome.is_unsatisfied()


def to_constraint_system(problem: Problem) -> ConstraintSystem:
    """Resolve labels to variable ids and lower instructions to constraints
    (``executor.rs:40-445``)."""
    guessmap_points: Dict[str, Tuple[float, float]] = {
        g.point: (g.x, g.y) for g in problem.point_guesses
    }
    guessmap_scalars: Dict[str, float] = {g.scalar: g.guess for g in problem.scalar_guesses}

    guesses: List[Tuple[int, float]] = []

    def push(value: float) -> int:
        vid = len(guesses)
        guesses.append((vid, value))
        return vid

    # Points first.
    point_ids: Dict[str, DatumPoint] = {}
    for label in problem.inner_points:
        if label not in guessmap_points:
            raise TextualMissingGuess(label=label)
        gx, gy = guessmap_points.pop(label)
        point_ids[label] = DatumPoint(push(gx), push(gy))
    # Then circles.
    circle_ids: Dict[str, DatumCircle] = {}
    for label in problem.inner_circles:
        center_label = f"{label}.center"
        if center_label not in guessmap_points:
            raise TextualMissingGuess(label=center_label)
        radius_label = f"{label}.radius"
        if radius_label not in guessmap_scalars:
            raise TextualMissingGuess(label=radius_label)
        cx, cy = guessmap_points.pop(center_label)
        r = guessmap_scalars.pop(radius_label)
        circle_ids[label] = DatumCircle(
            center=DatumPoint(push(cx), push(cy)), radius=DatumDistance(push(r))
        )
    # Then arcs.
    arc_ids: Dict[str, DatumCircularArc] = {}
    for label in problem.inner_arcs:
        needed = [f"{label}.center", f"{label}.a", f"{label}.b"]
        for lbl in needed:
            if lbl not in guessmap_points:
                raise TextualMissingGuess(label=lbl)
        ax, ay = guessmap_points.pop(f"{label}.a")
        bx, by = guessmap_points.pop(f"{label}.b")
        cx, cy = guessmap_points.pop(f"{label}.center")
        arc_ids[label] = DatumCircularArc(
            start=DatumPoint(push(ax), push(ay)),
            end=DatumPoint(push(bx), push(by)),
            center=DatumPoint(push(cx), push(cy)),
        )
    if guessmap_points:
        raise UnusedGuesses(labels=sorted(guessmap_points.keys()))
    if guessmap_scalars:
        raise UnusedGuesses(labels=sorted(guessmap_scalars.keys()))

    def datum_point(label: Label) -> DatumPoint:
        """Label -> point datum, including circle/arc member labels
        (``executor.rs:121-174``)."""
        if label in point_ids:
            return point_ids[label]
        if label.endswith(".center"):
            base = label[: -len(".center")]
            if base in circle_ids:
                return circle_ids[base].center
            if base in arc_ids:
                return arc_ids[base].center
        if label.endswith(".a"):
            base = label[: -len(".a")]
            if base in arc_ids:
                return arc_ids[base].start
        if label.endswith(".b"):
            base = label[: -len(".b")]
            if base in arc_ids:
                return arc_ids[base].end
        raise UndefinedPoint(label=label)

    def datum_distance(label: Label) -> DatumDistance:
        if label.endswith(".radius"):
            base = label[: -len(".radius")]
            if base in circle_ids:
                return circle_ids[base].radius
        raise UndefinedPoint(label=label)

    def datum_circle(label: Label) -> DatumCircle:
        return DatumCircle(
            center=datum_point(f"{label}.center"), radius=datum_distance(f"{label}.radius")
        )

    def datum_arc(label: Label) -> DatumCircularArc:
        return DatumCircularArc(
            center=datum_point(f"{label}.center"),
            start=datum_point(f"{label}.a"),
            end=datum_point(f"{label}.b"),
        )

    def line(l0: Label, l1: Label) -> DatumLineSegment:
        return DatumLineSegment(datum_point(l0), datum_point(l1))

    constraints: List[Constraint] = []
    for instr in problem.instructions:
        op = instr.op
        ls = instr.labels
        if op in (Instruction.DECLARE_POINT, Instruction.DECLARE_CIRCLE,
                  Instruction.DECLARE_ARC, Instruction.LINE):
            continue
        if op == Instruction.CIRCLE_RADIUS:
            constraints.append(Constraint.CircleRadius(datum_circle(ls[0]), instr.value))
        elif op == Instruction.ARC_RADIUS:
            constraints.append(Constraint.ArcRadius(datum_arc(ls[0]), instr.value))
        elif op == Instruction.IS_ARC:
            constraints.append(Constraint.Arc(datum_arc(ls[0])))
        elif op == Instruction.POINT_LINE_DISTANCE:
            constraints.append(
                Constraint.PointLineDistance(datum_point(ls[0]), line(ls[1], ls[2]), instr.value)
            )
        elif op == Instruction.TANGENT:
            constraints.append(
                Constraint.LineTangentToCircle(
                    line(ls[0], ls[1]), datum_circle(ls[2]), LineSide.Undefined
                )
            )
        elif op == Instruction.FIX_POINT_COMPONENT:
            label = ls[0]
            if label in point_ids:
                pt = point_ids[label]
                vid = pt.x_id if instr.component is Component.X else pt.y_id
                constraints.append(Constraint.Fixed(vid, instr.value))
            elif label.endswith(".center"):
                # Reference quirk (``executor.rs:273-283``): a ``X.center =``
                # fix on a non-circle label is silently dropped.
                base = label[: -len(".center")]
                if base in circle_ids:
                    center = circle_ids[base].center
                    vid = center.x_id if instr.component is Component.X else center.y_id
                    constraints.append(Constraint.Fixed(vid, instr.value))
            else:
                raise UndefinedPoint(label=label)
        elif op == Instruction.FIX_CENTER_POINT_COMPONENT:
            label = ls[0]
            if label in circle_ids:
                center = circle_ids[label].center
            elif label in arc_ids:
                center = arc_ids[label].center
            else:
                raise UndefinedPoint(label=label)
            vid = center.x_id if instr.component is Component.X else center.y_id
            constraints.append(Constraint.Fixed(vid, instr.value))
        elif op == Instruction.VERTICAL:
            constraints.append(Constraint.Vertical(line(ls[0], ls[1])))
        elif op == Instruction.HORIZONTAL:
            constraints.append(Constraint.Horizontal(line(ls[0], ls[1])))
        elif op == Instruction.POINTS_COINCIDENT:
            constraints.append(
                Constraint.PointsCoincident(datum_point(ls[0]), datum_point(ls[1]))
            )
        elif op == Instruction.POINT_ARC_COINCIDENT:
            constraints.append(
                Constraint.PointArcCoincident(datum_arc(ls[1]), datum_point(ls[0]))
            )
        elif op == Instruction.MIDPOINT:
            constraints.append(
                Constraint.Midpoint(line(ls[0], ls[1]), datum_point(ls[2]))
            )
        elif op == Instruction.SYMMETRIC:
            constraints.append(
                Constraint.Symmetric(line(ls[0], ls[1]), datum_point(ls[2]), datum_point(ls[3]))
            )
        elif op == Instruction.DISTANCE:
            constraints.append(
                Constraint.Distance(datum_point(ls[0]), datum_point(ls[1]), instr.value)
            )
        elif op == Instruction.PARALLEL:
            constraints.append(
                Constraint.lines_parallel((line(ls[0], ls[1]), line(ls[2], ls[3])))
            )
        elif op == Instruction.PERPENDICULAR:
            constraints.append(
                Constraint.lines_perpendicular((line(ls[0], ls[1]), line(ls[2], ls[3])))
            )
        elif op == Instruction.LINES_EQUAL_LENGTH:
            constraints.append(
                Constraint.LinesEqualLength(line(ls[0], ls[1]), line(ls[2], ls[3]))
            )
        elif op == Instruction.ANGLE_LINE:
            constraints.append(
                Constraint.LinesAtAngle(
                    line(ls[0], ls[1]), line(ls[2], ls[3]), AngleKind.Other, instr.angle
                )
            )
        elif op == Instruction.ARC_LENGTH:
            constraints.append(Constraint.ArcLength(datum_arc(ls[0]), instr.value))
        else:
            raise UndefinedPoint(label=f"unhandled instruction {op}")

    # All textual constraints are max priority (executor.rs:429-435).
    reqs = [ConstraintRequest.new(c, 0) for c in constraints]
    return ConstraintSystem(
        constraints=reqs,
        initial_guesses=guesses,
        inner_points=list(problem.inner_points),
        inner_circles=list(problem.inner_circles),
        inner_arcs=list(problem.inner_arcs),
        inner_lines=list(problem.inner_lines),
    )
