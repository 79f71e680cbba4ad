"""Executor: parsed Problem -> constraint system -> named solved geometry.

Mirrors ``ezpz/src/textual/executor.rs``. Variable layout (the flat solver
vector) is: all points ``[x, y]``, then all circles ``[cx, cy, r]``, then all
arcs ``[ax, ay, bx, by, cx, cy]`` in declaration order. Note: the reference's
``geometry_variables.rs:92`` computes arc offsets *ignoring* circle variables
while its output path includes them (``executor.rs:549``) — a latent
mixed-circle+arc indexing bug. We use the one consistent layout
(points, circles, arcs) everywhere.

A copy of ``ezpz_tpu.textual.executor`` holding ``to_constraint_system``
and the ``ConstraintSystem`` data. The solve methods wait until this
package has its own solver API.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..constraints import Constraint, ConstraintRequest, LineSide
from ..datatypes import (
    AngleKind,
    Component,
    DatumCircle,
    DatumCircularArc,
    DatumDistance,
    DatumLineSegment,
    DatumPoint,
)
from ..utils.errors import TextualMissingGuess, UndefinedPoint, UnusedGuesses
from .problem import Instruction, Label, Problem

@dataclass
class ConstraintSystem:
    """A constraint system built from the textual format."""

    constraints: List[ConstraintRequest]
    initial_guesses: List[Tuple[int, float]]
    inner_points: List[Label]
    inner_circles: List[Label]
    inner_arcs: List[Label]
    inner_lines: List[Tuple[Label, Label]]


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
