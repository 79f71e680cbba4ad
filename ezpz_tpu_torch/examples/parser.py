"""Parse the ezpz text format, which describes a constraint system, then
solve that system.

Mirrors the reference's ``ezpz/examples/parser.rs`` workflow (and
``examples/parser.py`` of the JAX package): ``Problem.from_str`` ->
``to_constraint_system`` -> ``solve`` -> named geometry lookups.

    python -m ezpz_tpu_torch.examples.parser         # on the card
    python -m ezpz_tpu_torch.examples.parser --cpu
"""

import argparse

from ezpz_tpu_torch.textual import Problem

FILE = """\
# constraints
point p
point q
p.x = 0
p.y = 0
q.y = 0
vertical(p, q)

# guesses
p roughly (3, 4)
q roughly (5, 6)
"""


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="solve on the CPU")
    device = "cpu" if ap.parse_args(argv).cpu else None

    problem = Problem.from_str(FILE)
    system = problem.to_constraint_system()
    solution = system.solve(device=device)

    assert not solution.unsatisfied
    p = solution.get_point("p")
    q = solution.get_point("q")
    print(f"p = ({p.x:.6f}, {p.y:.6f})")
    print(f"q = ({q.x:.6f}, {q.y:.6f})")
    # p is pinned to the origin; vertical(p, q) + q.y = 0 puts q there too.
    assert abs(p.x) < 1e-5 and abs(p.y) < 1e-5
    assert abs(q.x) < 1e-5 and abs(q.y) < 1e-5


if __name__ == "__main__":
    main()
