"""A basic example for how to use the constraint solver.

Mirrors the reference's ``ezpz/examples/basic.rs`` (and ``examples/basic.py``
of the JAX package): pin P to the origin, require Q to be 4 units away,
seed rough guesses, solve, read back points.

    python -m ezpz_tpu_torch.examples.basic          # on the card
    python -m ezpz_tpu_torch.examples.basic --cpu
"""

import argparse

import ezpz_tpu_torch as ez


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="solve on the CPU")
    device = "cpu" if ap.parse_args(argv).cpu else None

    # Define the geometry. These entities don't have known positions yet;
    # the solver will place them.
    ids = ez.IdGenerator()
    p = ez.DatumPoint.new(ids)
    q = ez.DatumPoint.new(ids)

    # Define constraints on the geometric entities.
    requests = [
        # Fix P to the origin.
        ez.ConstraintRequest.highest_priority(ez.Constraint.Fixed(p.id_x(), 0.0)),
        ez.ConstraintRequest.highest_priority(ez.Constraint.Fixed(p.id_y(), 0.0)),
        # P and Q should be 4 units apart.
        ez.ConstraintRequest.highest_priority(ez.Constraint.Distance(p, q, 4.0)),
    ]

    # Provide initial guesses for their locations.
    initial_guesses = [
        (p.id_x(), 0.0),
        (p.id_y(), -0.02),
        (q.id_x(), 4.39),
        (q.id_y(), 4.38),
    ]

    # Run the solver! Definition errors raise ez.FailureOutcome; a solver
    # that merely fails to converge returns converged=False instead.
    try:
        solution = ez.solve(requests, initial_guesses, ez.Config(), device=device)
    except ez.FailureOutcome as failure:
        print(f"could not solve: {failure.error}")
        raise SystemExit(1)

    assert solution.is_satisfied()
    solved_p = solution.final_value_point(p)
    solved_q = solution.final_value_point(q)
    print(f"P = ({solved_p.x}, {solved_p.y})")
    print(f"Q = ({solved_q.x}, {solved_q.y})")
    dist = ((solved_p.x - solved_q.x) ** 2 + (solved_p.y - solved_q.y) ** 2) ** 0.5
    print(f"|PQ| = {dist:.9f}")


if __name__ == "__main__":
    main()
