"""ezpz_tpu_torch — the PyTorch and CUDA port of ezpz_tpu.

A 2D geometric constraint solver: points, lines, circles and arcs with 25
constraint types, solved by Levenberg-Marquardt. This package ports the
JAX package ``ezpz_tpu`` (which stays the reference) to PyTorch, with the
TPU's Pallas kernels rewritten by hand in CUDA C++ for the NVIDIA H100.

It holds the fleet paths of ``bench.py``: the textual front end
(``textual``), constraint lowering (``constraints``), per-type compilation
(``models.compiled``), component bucketing (``models.blocks``), the batched
Levenberg-Marquardt loop (``solver``, ``ops.linalg``) and
``batch.BatchSolver`` over it and over the coarse and fused fleet kernels
(``ops.coarse_fleet``, ``ops.fused_fleet``). The package imports ``torch``
and never ``jax``.
"""

from .config import Config
from .constraints import CircleSide, Constraint, ConstraintRequest, LineSide
from .datatypes import (
    Angle,
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
from .utils.errors import (
    EmptySystemNotAllowed,
    EzpzError,
    MissingGuess,
    NonLinearSystemError,
    TextualError,
    WrongNumberGuesses,
)
from .utils.ids import Id, IdGenerator

__all__ = [
    "Config",
    "Constraint",
    "ConstraintRequest",
    "LineSide",
    "CircleSide",
    "Angle",
    "AngleKind",
    "DatumPoint",
    "DatumLineSegment",
    "DatumCircle",
    "DatumCircularArc",
    "DatumDistance",
    "Point",
    "Circle",
    "Arc",
    "Component",
    "Id",
    "IdGenerator",
    "EzpzError",
    "NonLinearSystemError",
    "MissingGuess",
    "WrongNumberGuesses",
    "EmptySystemNotAllowed",
    "TextualError",
]

__version__ = "0.1.0"
