"""Parser for the textual problem format.

Line-oriented reimplementation of the reference's winnow grammar
(``ezpz/src/textual/parser.rs``): a ``# constraints`` section of one
instruction per line, a blank line, then a ``# guesses`` section. Labels are
alphanumeric (``parser.rs:495-499``); numbers allow ``sqrt(...)`` where the
reference's ``parse_number_expr`` does (``parser.rs:549-555``).

A copy of ``ezpz_tpu.textual.parser`` without its native fast path.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from ..datatypes import Angle, Component
from ..utils.errors import ParseError
from .problem import Instruction, PointGuess, Problem, ScalarGuess

_LABEL = r"[A-Za-z0-9]+"
_NUM = r"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"

_RE_DECLARE = re.compile(rf"^(point|circle|arc)\s+({_LABEL})$")
_RE_FIX_CENTER = re.compile(rf"^({_LABEL})\.center\.([xy])\s*=\s*({_NUM})$")
_RE_FIX_POINT = re.compile(rf"^({_LABEL})\.([xy])\s*=\s*({_NUM})$")
_RE_ASSIGN = re.compile(
    rf"^({_LABEL}(?:\.{_LABEL})?)\s*=\s*\(\s*({_NUM})\s*,\s*({_NUM})\s*\)$"
)
_RE_CALL = re.compile(rf"^([a-z_]+)\s*\((.*)\)$")
_RE_POINT_GUESS = re.compile(
    rf"^({_LABEL}(?:\.{_LABEL})?)\s+roughly\s+\(\s*({_NUM})\s*,\s*({_NUM})\s*\)$"
)
_RE_SCALAR_GUESS = re.compile(rf"^({_LABEL}(?:\.{_LABEL})?)\s+roughly\s+({_NUM})$")
_RE_ANGLE = re.compile(rf"^({_NUM})\s*(deg|rad)$")
_RE_NUM = re.compile(rf"^{_NUM}$")


def _parse_number_expr(tok: str) -> float:
    """A number, or sqrt(<number expr>) (``parser.rs:549-555``)."""
    tok = tok.strip()
    if _RE_NUM.match(tok):
        return float(tok)
    if tok.startswith("sqrt(") and tok.endswith(")"):
        return _parse_number_expr(tok[len("sqrt("):-1]) ** 0.5
    raise ParseError(f"expected a number, got {tok!r}")


def _parse_angle(tok: str) -> Angle:
    m = _RE_ANGLE.match(tok.strip())
    if not m:
        raise ParseError(f"expected an angle like '90deg' or '1.5rad', got {tok!r}")
    value = float(m.group(1))
    return Angle.from_degrees(value) if m.group(2) == "deg" else Angle.from_radians(value)


def _split_args(raw: str) -> List[str]:
    """Split call arguments on top-level commas (sqrt(...) args contain no
    commas in this grammar, so a paren-depth scan suffices)."""
    args, depth, cur = [], 0, []
    for ch in raw:
        if ch == "(":
            depth += 1
            cur.append(ch)
        elif ch == ")":
            depth -= 1
            cur.append(ch)
        elif ch == "," and depth == 0:
            args.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        args.append(tail)
    return args


def _labels(args: List[str], n: int, op: str) -> Tuple[str, ...]:
    if len(args) != n:
        raise ParseError(f"{op} expects {n} arguments, got {len(args)}: {args}")
    for a in args:
        if not re.fullmatch(_LABEL, a):
            raise ParseError(f"{op}: expected a label, got {a!r}")
    return tuple(args)


_CALL_OPS = {
    # name -> (number of leading labels, trailing kind: None | 'num' | 'numexpr' | 'angle')
    "horizontal": (2, None),
    "vertical": (2, None),
    "coincident": (2, None),
    "point_arc_coincident": (2, None),
    "midpoint": (3, None),
    "symmetric": (4, None),
    "parallel": (4, None),
    "perpendicular": (4, None),
    "lines_equal_length": (4, None),
    "line": (2, None),
    "is_arc": (1, None),
    "distance": (2, "numexpr"),
    "radius": (1, "numexpr"),
    "tangent": (3, None),
    "arc_radius": (1, "numexpr"),
    "arc_length": (1, "numexpr"),
    "lines_at_angle": (4, "angle"),
    "point_line_distance": (3, "numexpr"),
}


def _parse_instruction_line(line: str) -> List[Instruction]:
    m = _RE_DECLARE.match(line)
    if m:
        kind, label = m.groups()
        op = {
            "point": Instruction.DECLARE_POINT,
            "circle": Instruction.DECLARE_CIRCLE,
            "arc": Instruction.DECLARE_ARC,
        }[kind]
        return [Instruction(op, labels=(label,))]

    m = _RE_FIX_CENTER.match(line)
    if m:
        label, comp, num = m.groups()
        return [Instruction(
            Instruction.FIX_CENTER_POINT_COMPONENT,
            labels=(label,),
            component=Component.X if comp == "x" else Component.Y,
            value=float(num),
        )]

    m = _RE_FIX_POINT.match(line)
    if m:
        label, comp, num = m.groups()
        return [Instruction(
            Instruction.FIX_POINT_COMPONENT,
            labels=(label,),
            component=Component.X if comp == "x" else Component.Y,
            value=float(num),
        )]

    m = _RE_ASSIGN.match(line)
    if m:
        label, x, y = m.groups()
        # p = (x, y) sugar desugars to two component fixes (parser.rs:452-471).
        return [
            Instruction(Instruction.FIX_POINT_COMPONENT, labels=(label,),
                        component=Component.X, value=float(x)),
            Instruction(Instruction.FIX_POINT_COMPONENT, labels=(label,),
                        component=Component.Y, value=float(y)),
        ]

    m = _RE_CALL.match(line)
    if m:
        name, raw_args = m.groups()
        if name not in _CALL_OPS:
            raise ParseError(f"unknown instruction {name!r} in line {line!r}")
        n_labels, trailing = _CALL_OPS[name]
        args = _split_args(raw_args)
        if trailing is None:
            labels = _labels(args, n_labels, name)
            return [Instruction(name, labels=labels)]
        labels = _labels(args[:-1], n_labels, name)
        if len(args) != n_labels + 1:
            raise ParseError(f"{name} expects {n_labels + 1} arguments, got {len(args)}")
        if trailing == "angle":
            return [Instruction(name, labels=labels, angle=_parse_angle(args[-1]))]
        return [Instruction(name, labels=labels, value=_parse_number_expr(args[-1]))]

    raise ParseError(f"could not parse instruction line {line!r}")


def _parse_guess_line(line: str):
    m = _RE_POINT_GUESS.match(line)
    if m:
        label, x, y = m.groups()
        return PointGuess(point=label, x=float(x), y=float(y))
    m = _RE_SCALAR_GUESS.match(line)
    if m:
        label, num = m.groups()
        return ScalarGuess(scalar=label, guess=float(num))
    raise ParseError(f"could not parse guess line {line!r}")


def parse_problem(text: str) -> Problem:
    """Parse a textual problem with the pure-Python grammar. The JAX
    package's native C++ parser is not part of this package yet."""
    return _parse_problem_py(text)


def _parse_problem_py(text: str) -> Problem:
    lines = [ln.strip() for ln in text.splitlines()]
    section = None  # None | 'constraints' | 'guesses'
    instructions: List[Instruction] = []
    guesses: List = []
    for ln in lines:
        if not ln:
            continue
        header = re.match(r"^#\s*(constraints|guesses)$", ln)
        if header:
            section = header.group(1)
            continue
        if section == "constraints":
            instructions.extend(_parse_instruction_line(ln))
        elif section == "guesses":
            guesses.append(_parse_guess_line(ln))
        else:
            raise ParseError(f"content before '# constraints' header: {ln!r}")
    if section is None:
        raise ParseError("missing '# constraints' header")

    problem = Problem()
    problem.instructions = instructions
    for instr in instructions:
        if instr.op == Instruction.DECLARE_POINT:
            problem.inner_points.append(instr.labels[0])
        elif instr.op == Instruction.DECLARE_CIRCLE:
            problem.inner_circles.append(instr.labels[0])
        elif instr.op == Instruction.DECLARE_ARC:
            problem.inner_arcs.append(instr.labels[0])
        elif instr.op == Instruction.LINE:
            problem.inner_lines.append((instr.labels[0], instr.labels[1]))
    for g in guesses:
        if isinstance(g, PointGuess):
            problem.point_guesses.append(g)
        else:
            problem.scalar_guesses.append(g)
    return problem
