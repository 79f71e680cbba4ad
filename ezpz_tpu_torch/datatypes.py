"""Geometric datums (inputs) and solved geometry (outputs).

Mirrors the reference's ``ezpz/src/datatypes{.rs,/inputs.rs,/outputs.rs}``.
A datum only carries the *ids* of its scalar unknowns; values live in the
flat variable vector owned by the solver.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum

from .utils.ids import Id, IdGenerator


# ---------------------------------------------------------------------------
# Angles


class AngleKind(Enum):
    """Special or explicit angle between two lines (``datatypes.rs:9-16``)."""

    Parallel = "parallel"
    Perpendicular = "perpendicular"
    Other = "other"


@dataclass(frozen=True)
class Angle:
    """An angle in degrees or radians (``datatypes.rs:22-89``)."""

    val: float
    degrees: bool

    @staticmethod
    def from_degrees(degrees: float) -> "Angle":
        return Angle(degrees, True)

    @staticmethod
    def from_radians(radians: float) -> "Angle":
        return Angle(radians, False)

    def to_degrees(self) -> float:
        return self.val if self.degrees else math.degrees(self.val)

    def to_radians(self) -> float:
        return math.radians(self.val) if self.degrees else self.val

    def __str__(self) -> str:
        return f"{self.val}deg" if self.degrees else f"{self.val}rad"


# ---------------------------------------------------------------------------
# Input datums


@dataclass(frozen=True)
class DatumDistance:
    """A solver-determined distance (one variable), ``inputs.rs:19-42``."""

    id: Id

    def all_variables(self) -> tuple:
        return (self.id,)


@dataclass(frozen=True)
class DatumPoint:
    """A 2D point; two variables (x, y), ``inputs.rs:54-107``."""

    x_id: Id
    y_id: Id

    @staticmethod
    def new(ids: IdGenerator) -> "DatumPoint":
        return DatumPoint(ids.next_id(), ids.next_id())

    @staticmethod
    def new_xy(x: Id, y: Id) -> "DatumPoint":
        return DatumPoint(x, y)

    def id_x(self) -> Id:
        return self.x_id

    def id_y(self) -> Id:
        return self.y_id

    def all_variables(self) -> tuple:
        return (self.x_id, self.y_id)


@dataclass(frozen=True)
class DatumLineSegment:
    """A finite line segment between two datum points, ``inputs.rs:114-146``."""

    p0: DatumPoint
    p1: DatumPoint

    def all_variables(self) -> tuple:
        return self.p0.all_variables() + self.p1.all_variables()


@dataclass(frozen=True)
class DatumCircle:
    """A circle: a center point and a radius variable, ``inputs.rs:151-163``."""

    center: DatumPoint
    radius: DatumDistance

    def all_variables(self) -> tuple:
        return (self.center.x_id, self.center.y_id, self.radius.id)


@dataclass(frozen=True)
class DatumCircularArc:
    """A CCW circular arc: center, start, end points, ``inputs.rs:171-193``.

    Variable order matches the reference: start, end, center.
    """

    center: DatumPoint
    start: DatumPoint
    end: DatumPoint

    def all_variables(self) -> tuple:
        return (
            self.start.x_id,
            self.start.y_id,
            self.end.x_id,
            self.end.y_id,
            self.center.x_id,
            self.center.y_id,
        )


# ---------------------------------------------------------------------------
# Outputs (solved geometry)


@dataclass(frozen=True)
class Point:
    x: float
    y: float

    def euclidean_distance(self, other: "Point") -> float:
        return math.hypot(self.x - other.x, self.y - other.y)

    def __str__(self) -> str:
        return f"({self.x},{self.y})"


@dataclass(frozen=True)
class Circle:
    radius: float
    center: Point


@dataclass(frozen=True)
class Arc:
    a: Point
    b: Point
    center: Point


class Component(Enum):
    """Component of a 2D point (``outputs.rs:63-69``)."""

    X = "x"
    Y = "y"
