"""Problem AST: instructions + guesses (``ezpz/src/textual/{textual,instruction}.rs``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..datatypes import Angle, Component

Label = str


@dataclass(frozen=True)
class PointGuess:
    point: Label
    x: float
    y: float


@dataclass(frozen=True)
class ScalarGuess:
    scalar: Label
    guess: float


# Instruction kinds (ezpz/src/textual/instruction.rs:6-30). One dataclass
# with a tag keeps the executor dispatch flat.
@dataclass(frozen=True)
class Instruction:
    op: str
    labels: Tuple[Label, ...] = ()
    value: Optional[float] = None
    component: Optional[Component] = None
    angle: Optional[Angle] = None

    # op names
    DECLARE_POINT = "declare_point"
    DECLARE_CIRCLE = "declare_circle"
    DECLARE_ARC = "declare_arc"
    FIX_POINT_COMPONENT = "fix_point_component"
    FIX_CENTER_POINT_COMPONENT = "fix_center_point_component"
    VERTICAL = "vertical"
    HORIZONTAL = "horizontal"
    DISTANCE = "distance"
    PARALLEL = "parallel"
    PERPENDICULAR = "perpendicular"
    ANGLE_LINE = "lines_at_angle"
    POINTS_COINCIDENT = "coincident"
    POINT_ARC_COINCIDENT = "point_arc_coincident"
    MIDPOINT = "midpoint"
    SYMMETRIC = "symmetric"
    CIRCLE_RADIUS = "radius"
    TANGENT = "tangent"
    ARC_RADIUS = "arc_radius"
    LINES_EQUAL_LENGTH = "lines_equal_length"
    IS_ARC = "is_arc"
    POINT_LINE_DISTANCE = "point_line_distance"
    LINE = "line"
    ARC_LENGTH = "arc_length"


@dataclass
class Problem:
    """A parsed problem (``textual.rs:33-42``).

    Parse the reference textual format and lower it to constraints:

    >>> p = Problem.from_str('''
    ... # constraints
    ... point p
    ... point q
    ... p = (0, 0)
    ... distance(p, q, 5)
    ... horizontal(p, q)
    ...
    ... # guesses
    ... p roughly (0.1, -0.1)
    ... q roughly (4.5, 0.3)
    ... ''')
    >>> cs = p.to_constraint_system()
    >>> [r.constraint.kind for r in cs.constraints]
    ['Fixed', 'Fixed', 'Distance', 'Horizontal']
    >>> cs.initial_guesses
    [(0, 0.1), (1, -0.1), (2, 4.5), (3, 0.3)]
    """

    instructions: List[Instruction] = field(default_factory=list)
    inner_points: List[Label] = field(default_factory=list)
    inner_circles: List[Label] = field(default_factory=list)
    inner_arcs: List[Label] = field(default_factory=list)
    inner_lines: List[Tuple[Label, Label]] = field(default_factory=list)
    point_guesses: List[PointGuess] = field(default_factory=list)
    scalar_guesses: List[ScalarGuess] = field(default_factory=list)

    @staticmethod
    def from_str(text: str) -> "Problem":
        from .parser import parse_problem

        return parse_problem(text)

    def to_constraint_system(self):
        from .executor import to_constraint_system

        return to_constraint_system(self)
