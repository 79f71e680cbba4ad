"""Scale demo: fleets of independent sketches and one coupled system, the
two capabilities beyond the reference's single-solve API (the counterpart
of ``examples/scale.py`` of the JAX package).

    python -m ezpz_tpu_torch.examples.scale          # on the card
    python -m ezpz_tpu_torch.examples.scale --cpu

1. A FLEET: 4,096 copies of the same sketch topology (pin P, hold Q at a
   per-sketch distance) solved in one batched call of ``BatchSolver``.
2. A COUPLED system: a chain of vertical lines tied together by
   lines_equal_length. No block-diagonal decomposition exists, so it runs
   through the partitioned-Schur ``BlockSchurSolver`` (the answer to the
   reference's sparse LLT).
"""

import argparse

import numpy as np


def fleet(device) -> None:
    from ezpz_tpu_torch import Constraint, DatumPoint
    from ezpz_tpu_torch.batch import BatchSolver
    from ezpz_tpu_torch.config import Config
    from ezpz_tpu_torch.models.compiled import compile_system

    p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    system = compile_system(
        [Constraint.Fixed(0, 0.0), Constraint.Fixed(1, 0.0),
         Constraint.Distance(p, q, 5.0)],  # the 5.0 is overridden per sketch
        n_vars=4,
    )
    B = 4096
    rng = np.random.default_rng(0)
    x0 = np.zeros((B, 4))
    x0[:, 2:] = rng.uniform(1.0, 9.0, size=(B, 2))
    # Per-sketch parameters: every sketch asks for its own distance.
    distances = rng.uniform(2.0, 8.0, size=B)
    pars = []
    for b in system.blocks:
        par = np.tile(np.asarray(b.par), (B, 1, 1))
        if b.spec.name == "distance":
            par[:, 0, 0] = distances
        pars.append(par)

    solver = BatchSolver(system, Config(), batch_params=True, device=device)
    out = solver.solve(x0, tuple(pars))
    x = out.x.cpu().numpy()
    got = np.hypot(x[:, 2], x[:, 3])
    ok = bool(out.converged.all()) and np.allclose(got, distances)
    print(f"fleet: {B} sketches, all converged = {ok}, "
          f"max |distance error| = {np.max(np.abs(got - distances)):.2e}")


def coupled(device) -> None:
    from ezpz_tpu_torch import Constraint, DatumLineSegment, DatumPoint
    from ezpz_tpu_torch.parallel import BlockSchurSolver

    n_lines = 40
    constraints = []
    n_vars = n_lines * 4
    x0 = np.zeros(n_vars)
    pts = []
    for i in range(n_lines):
        a = DatumPoint(4 * i, 4 * i + 1)
        b = DatumPoint(4 * i + 2, 4 * i + 3)
        pts.append((a, b))
        constraints.append(Constraint.Vertical(DatumLineSegment(a, b)))
        constraints.append(Constraint.Fixed(a.x_id, float(i)))
        constraints.append(Constraint.Fixed(a.y_id, 0.0))
        x0[4 * i:4 * i + 4] = [i, 0.1, i, 3.5]
    constraints.append(Constraint.Fixed(pts[0][1].y_id, 4.0))
    for i in range(n_lines - 1):
        constraints.append(Constraint.LinesEqualLength(
            DatumLineSegment(*pts[i]), DatumLineSegment(*pts[i + 1])))

    solver = BlockSchurSolver(constraints, n_vars, precision="mixed", device=device)
    out = solver.solve(x0)
    heights = [out["x"][4 * i + 3] for i in range(n_lines)]
    print(f"coupled: {n_vars} vars across {out['n_parts']} partitions "
          f"({out['n_boundary']} boundary vars), converged = {out['converged']}, "
          f"all line lengths = {heights[0]:.6f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="solve on the CPU")
    device = "cpu" if ap.parse_args(argv).cpu else None
    fleet(device)
    coupled(device)


if __name__ == "__main__":
    main()
