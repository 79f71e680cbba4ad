"""Fuzz contract for the port's ``solve``: arbitrary constraint systems must
never crash it.

The reference ships a libfuzzer target (``fuzz/fuzz_targets/
fuzz_target_1.rs``) and ``tests/test_fuzz.py`` holds the JAX package to
it. Here the same hypothesis strategies (``constraints``) and the same
committed regression corpus drive ``ezpz_tpu_torch.solve(...,
device="cpu")``: it returns a ``SolveOutcome`` whose iterations are an
``int`` in [0, 35] and whose final values are real floats, or raises the
port's typed ``FailureOutcome``, and nothing else.

On the corpus's 13 pinned systems JAX's ``solve`` runs too: the port must
raise exactly when JAX raises, and where both return, the unsatisfied
constraints (so the satisfied ones) and the converged flag must be equal.
Coordinates are compared (within 1e-6) only where the system is fully
constrained (the port's freedom analysis finds no free variable): on an
underconstrained sketch LM may stop anywhere on the solution set. The
strategies build JAX objects; ``to_port`` rebuilds each one from the
port's classes of the same names.

``EZPZ_TPU_FUZZ_EXAMPLES`` (default 20) sets the number of random
examples, as for ``tests/test_fuzz.py``.
"""

import dataclasses
import enum
import math
import os

import pytest
from hypothesis import given, settings, strategies as st

import ezpz_tpu as jez
import ezpz_tpu_torch as tez
from ezpz_tpu import constraints as jconstraints, datatypes as jdatatypes
from ezpz_tpu.constraints import ConstraintRequest
from ezpz_tpu_torch import constraints as tconstraints, datatypes as tdatatypes

from . import test_fuzz
from .test_fuzz import N_VARS, constraints, vals

_PORT_MODULES = {jconstraints.__name__: tconstraints, jdatatypes.__name__: tdatatypes}


def to_port(obj):
    """The port's counterpart of a JAX constraint or datum: the class of the
    same name in the port's module, rebuilt field by field."""
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_port(v) for v in obj)
    if isinstance(obj, dict):
        return {k: to_port(v) for k, v in obj.items()}
    module = _PORT_MODULES.get(type(obj).__module__)
    if module is None:
        return obj
    cls = getattr(module, type(obj).__name__)
    if isinstance(obj, enum.Enum):
        return cls[obj.name]
    return cls(**{f.name: to_port(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def port_solve(cs, guesses):
    """The port's outcome on highest-priority ``cs`` (JAX objects), or its
    ``FailureOutcome``; any other exception propagates."""
    reqs = [tez.ConstraintRequest.highest_priority(to_port(c)) for c in cs]
    try:
        return tez.solve(reqs, list(enumerate(guesses)), tez.Config(), device="cpu")
    except tez.FailureOutcome as failure:
        return failure


def check_contract(out):
    if isinstance(out, tez.FailureOutcome):
        return
    assert isinstance(out, tez.SolveOutcome)
    assert isinstance(out.iterations, int) and 0 <= out.iterations <= 35
    assert isinstance(out.converged, bool)
    assert len(out.final_values) == N_VARS
    assert all(isinstance(v, float) for v in out.final_values)
    assert all(isinstance(i, int) for i in out.unsatisfied)


@settings(max_examples=int(os.environ.get("EZPZ_TPU_FUZZ_EXAMPLES", "20")), deadline=None)
@given(
    cs=st.lists(constraints(), min_size=0, max_size=4),
    guesses=st.lists(vals, min_size=N_VARS, max_size=N_VARS),
)
def test_port_fuzz_solve_never_crashes(cs, guesses):
    check_contract(port_solve(cs, guesses))


# ``tests/test_fuzz.py``'s committed corpus (its ``@example``s, which
# hypothesis keeps on the test in the reverse of their written order).
CORPUS = [e.kwargs for e in reversed(test_fuzz.test_fuzz_solve_never_crashes
                                      .hypothesis_explicit_examples)]


@pytest.mark.parametrize("case", range(len(CORPUS)))
def test_port_fuzz_corpus_matches_jax(case):
    cs, guesses = CORPUS[case]["cs"], CORPUS[case]["guesses"]
    out = port_solve(cs, guesses)
    check_contract(out)
    try:
        ref = jez.solve([ConstraintRequest.highest_priority(c) for c in cs],
                        list(enumerate(guesses)), jez.Config())
    except jez.FailureOutcome as failure:
        ref = failure
    assert isinstance(out, tez.FailureOutcome) == isinstance(ref, jez.FailureOutcome)
    if isinstance(out, tez.FailureOutcome):
        assert type(out.error).__name__ == type(ref.error).__name__
        return
    assert sorted(out.unsatisfied) == sorted(ref.unsatisfied)
    assert out.converged == ref.converged
    reqs = [tez.ConstraintRequest.highest_priority(to_port(c)) for c in cs]
    free = tez.solve_analysis(reqs, list(enumerate(guesses)), tez.Config(),
                              device="cpu").analysis.is_underconstrained()
    if not free:
        for got, want in zip(out.final_values, ref.final_values):
            assert math.isclose(got, want, rel_tol=0.0, abs_tol=1e-6)
