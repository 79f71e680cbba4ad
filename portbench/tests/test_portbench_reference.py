"""The plain reference agrees with the program's plain path, and the
check separates the program from its control and from planted faults."""

import numpy as np
import pytest
import torch

from rehearsal import (CELLS, FAULTS, cell as rehearsal_cell, harness, loop, overrides,
                       rehearse)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_residuals_match_the_program(cell):
    """At seeded points the cell's reference's residual rows equal the
    program's compiled residuals (same rows: every kind here lowers to
    one)."""
    from ezpz_tpu_torch.models.compiled import compile_system

    c = rehearsal_cell(cell)
    sk = c.sketch
    system = compile_system([r.constraint for r in c.sketch_mod.port_requests(c.cfg)],
                            sk.n_vars)
    x = sk.guess + np.random.default_rng(5).normal(0, 0.3, sk.n_vars)
    ours = c.reference.residual(sk.kinds, sk.ids, sk.params, x)
    theirs = system.residual(torch.as_tensor(x)[None])[0].numpy()
    order = np.concatenate([b.cid for b in system.blocks])
    np.testing.assert_allclose(theirs, ours[order], rtol=0, atol=1e-12)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_solves_what_the_program_solves(cell):
    """A few lanes through the program's plain path on the CPU and through
    the cell's reference: the same verdicts and the same answers."""
    from portbench import check

    c = rehearsal_cell(cell)
    rng = np.random.default_rng(3)
    c.loop.prepare(99)
    c.loop.run(count=1, keep={0})
    found = check.numbers(c.reference, c.sketch, c.loop.answers(rng))
    assert found["flags_off"] == 0 and found["cases"] > 0
    assert found["x_gap"] < c.limits["x_gap"] and found["resid"] <= c.limits["resid"]


@pytest.mark.parametrize("cell", CELLS)
def test_check_through_the_named_reference_is_the_accepted_one(cell):
    """The check through the reference module that the cell loads by the
    configuration's name reads exactly what it reads through that module
    imported as a package module, as ``check.py`` imported ``lm`` before
    configurations named their reference: program and control alike."""
    import importlib

    from portbench import check

    c = rehearsal_cell(cell)
    imported = importlib.import_module(f"portbench.reference.{c.cfg['reference']}")
    assert c.reference.__file__ == imported.__file__
    rng = np.random.default_rng(6)
    c.loop.prepare(2**34 + 1)
    c.loop.run(count=2, keep=c.loop.keep_for(rng, 2))
    cases = c.loop.answers(rng)
    assert check.numbers(c.reference, c.sketch, cases) == check.numbers(imported, c.sketch, cases)
    assert (check.numbers(c.reference, c.sketch, check.control_cases(c.reference, c.sketch, cases))
            == check.numbers(imported, c.sketch, check.control_cases(imported, c.sketch, cases)))


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference in float32 in the program's place fails the check, at
    the configuration's published size, where the limits were read, with
    the rehearsal's traffic."""
    from portbench import check

    c = harness.Cell(cell, "cpu", {"traffic": overrides(cell).get("traffic", {})})
    rng = np.random.default_rng(4)
    c.loop.prepare(2**35)
    c.loop.run(count=2, keep=c.loop.keep_for(rng, 2))
    cases = c.loop.answers(rng)
    assert check.verdict(check.numbers(c.reference, c.sketch, cases), c.limits)[0]
    control = check.numbers(c.reference, c.sketch,
                            check.control_cases(c.reference, c.sketch, cases))
    correct, shown = check.verdict(control, c.limits)
    assert not correct
    assert shown["resid"]["value"] > 3 * shown["resid"]["limit"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_run_with_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    """The whole run, past the look for a card, with the timed path broken
    underneath by the cell's own loop (its ``plant``): ``correct`` comes
    out false."""
    loop(cell).plant(monkeypatch.setattr, FAULTS[fault])
    result, lines = rehearse(cell)
    assert result["correct"] is False, lines


def _plant_in_batch_solver(monkeypatch, change):
    """How the fault test broke every cell before each loop planted its own
    faults: ``BatchSolver.solve`` wrapped, the witness for ``loops/fleet``."""
    from ezpz_tpu_torch import batch

    real = batch.BatchSolver.solve

    def broken(self, x0, pars=None, *a, **k):
        out = real(self, x0, pars, *a, **k)
        return batch.BatchResult(change(out.x, x0), out.iterations, out.converged,
                                 out.satisfied, out.degenerate)

    monkeypatch.setattr(batch.BatchSolver, "solve", broken)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", [c for c in CELLS if loop(c).__name__ == "portbench.loops.fleet"])
def test_fleet_plant_breaks_what_the_test_broke_before(monkeypatch, cell, fault):
    """``loops/fleet.plant`` breaks the timed path as the fault test's own
    wrapper did: the same check numbers at the same seed (traced runs, a
    fixed count of batches)."""
    with monkeypatch.context() as m:
        _plant_in_batch_solver(m, FAULTS[fault])
        before, _ = rehearse(cell, traced=True)
    with monkeypatch.context() as m:
        loop(cell).plant(m.setattr, FAULTS[fault])
        after, _ = rehearse(cell, traced=True)
    assert before["correct"] is False
    assert after["checks"] == before["checks"]
