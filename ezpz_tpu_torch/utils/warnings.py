"""User-facing warnings and static lints.

Mirrors ``ezpz/src/warnings.rs``: degenerate-geometry warnings from the
numeric path, plus static lints that suggest Parallel/Perpendicular instead
of numerically-equivalent explicit angles. A copy of
``ezpz_tpu.utils.warnings``.
"""

from dataclasses import dataclass
from enum import Enum
from typing import Optional

EPSILON = 1e-4  # ezpz/src/lib.rs:43


class WarningKind(Enum):
    DEGENERATE = "degenerate"
    SHOULD_BE_PARALLEL = "should_be_parallel"
    SHOULD_BE_PERPENDICULAR = "should_be_perpendicular"


# Keep the reference's names available (WarningContent enum variants).
class WarningContent:
    Degenerate = WarningKind.DEGENERATE
    ShouldBeParallel = WarningKind.SHOULD_BE_PARALLEL
    ShouldBePerpendicular = WarningKind.SHOULD_BE_PERPENDICULAR


@dataclass(frozen=True)
class Warning:
    """Something bad that users should know about."""

    about_constraint: Optional[int]
    content: WarningKind
    # For ShouldBe* warnings: the offending angle, in degrees.
    angle_degrees: Optional[float] = None

    def __str__(self) -> str:
        if self.content is WarningKind.DEGENERATE:
            return (
                "This geometry is degenerate, meaning two points are so close "
                "together that they practically overlap. This is probably "
                "unintentional; place your initial guesses further apart or "
                "choose different constraints."
            )
        if self.content is WarningKind.SHOULD_BE_PARALLEL:
            return f"Instead of constraining to {self.angle_degrees}deg, constrain to Parallel"
        return f"Instead of constraining to {self.angle_degrees}deg, constrain to Perpendicular"


def _nearly_eq(a: float, b: float) -> bool:
    return abs(a - b) < EPSILON


def lint(entries) -> list:
    """Static lints over constraint entries (``ezpz/src/warnings.rs:34-60``).

    ``entries`` is a sequence of (constraint_id, constraint) pairs where the
    constraint is an ``ezpz_tpu_torch.constraints.Constraint``.
    """
    from ..constraints import Constraint  # local import to avoid a cycle
    from ..datatypes import AngleKind

    warnings = []
    for cid, c in entries:
        if c.kind != Constraint.LINES_AT_ANGLE:
            continue
        angle_kind, angle = c.payload.get("angle_kind"), c.payload.get("angle")
        if angle_kind is not AngleKind.Other or angle is None:
            continue
        deg = angle.to_degrees()
        if _nearly_eq(deg, 0.0) or _nearly_eq(deg, 360.0) or _nearly_eq(deg, 180.0):
            warnings.append(
                Warning(
                    about_constraint=cid,
                    content=WarningKind.SHOULD_BE_PARALLEL,
                    angle_degrees=deg,
                )
            )
        elif _nearly_eq(deg, 90.0) or _nearly_eq(deg, -90.0):
            warnings.append(
                Warning(
                    about_constraint=cid,
                    content=WarningKind.SHOULD_BE_PERPENDICULAR,
                    angle_degrees=deg,
                )
            )
    return warnings
