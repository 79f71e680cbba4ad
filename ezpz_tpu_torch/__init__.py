"""ezpz_tpu_torch — the PyTorch and CUDA port of ezpz_tpu.

A 2D geometric constraint solver: points, lines, circles and arcs with 25
constraint types, solved by Levenberg-Marquardt. This package ports the
JAX package ``ezpz_tpu`` (which stays the reference) to PyTorch, with the
TPU's Pallas kernels rewritten by hand in CUDA C++ for the NVIDIA H100.

The public API is the JAX package's: ``solve`` and ``solve_analysis``
(``api``), the textual format's ``ConstraintSystem.solve*``
(``textual``), the outcome types (``outcomes``), and the CLI
(``python -m ezpz_tpu_torch.cli``). Every entry point runs on the card
unless the caller passes ``device="cpu"``; without a card it raises.
Under it: constraint lowering (``constraints``), per-type compilation
(``models.compiled``), component bucketing and the decomposed solvers
(``models.blocks``: ``BlockProgram``, ``BlockSolver``), the batched
Levenberg-Marquardt loop (``solver``, ``ops.linalg``), freedom analysis
(``dof``), and ``batch.BatchSolver`` over the loop and over the coarse and
fused fleet kernels (``ops.coarse_fleet``, ``ops.fused_fleet``);
``parallel`` (``BlockSchurSolver`` for coupled systems, ``FleetSolver``
over several devices), ``residual_viz`` and ``examples``. The package
imports ``torch`` and never ``jax``.

``EZPZ_TPU_DEBUG_NANS=1`` (``EZPZ_TPU_DEBUG_INFS=1``), read at import,
makes the first torch operation that produces a NaN (an Inf) raise
``FloatingPointError`` naming it (``utils.debug``). Off by default: the
solver uses NaN on a non-SPD factorization as its failure signal.
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
from .utils.warnings import Warning, WarningContent
from .outcomes import SolveOutcome, FailureOutcome, FreedomAnalysis, SolveOutcomeFreedomAnalysis
from .api import solve, solve_analysis
from .utils import debug as _debug

_debug.arm_from_env()

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
    "Warning",
    "WarningContent",
    "EzpzError",
    "NonLinearSystemError",
    "MissingGuess",
    "WrongNumberGuesses",
    "EmptySystemNotAllowed",
    "TextualError",
    "SolveOutcome",
    "FailureOutcome",
    "FreedomAnalysis",
    "SolveOutcomeFreedomAnalysis",
    "solve",
    "solve_analysis",
]

__version__ = "0.1.0"
