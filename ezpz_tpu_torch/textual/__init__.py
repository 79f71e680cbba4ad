"""Textual problem format: parser and executor.

The format (``ezpz/src/textual/``):

    # constraints
    point p
    point q
    p = (0, 0)
    vertical(p, q)

    # guesses
    p roughly (3, 4)
    q roughly (5, 6)

The executor resolves labels to variable ids and produces
``ConstraintRequest``s that ``models.compiled`` groups into per-type
index/param arrays.
"""

from .problem import Problem, Label, PointGuess, ScalarGuess
from .executor import ConstraintSystem

__all__ = [
    "Problem",
    "Label",
    "PointGuess",
    "ScalarGuess",
    "ConstraintSystem",
]
