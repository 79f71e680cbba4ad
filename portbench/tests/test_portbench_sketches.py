"""The configurations' generators give the published sketches: the massive
text byte for byte, and the same constraints to the program and to the
reference."""

import json
from pathlib import Path

import numpy as np
import pytest

from rehearsal import harness

REPO = Path(__file__).resolve().parents[2]
MASSIVE = json.loads((REPO / "portbench/configs/massive_parallel_system.json").read_text())
CHAIN = json.loads((REPO / "portbench/configs/rect_chain64.json").read_text())


def test_massive_text_is_the_fixture_byte_for_byte():
    mod = harness.module("sketches", "massive_lines")
    fixture = (REPO / "tests/cases/massive_parallel_system/problem.md").read_text()
    assert mod.text(MASSIVE) == fixture


def test_rect_chain_is_the_port_fixture():
    from ezpz_tpu_torch import fixtures

    mod = harness.module("sketches", "rect_chain")
    cons, x0 = fixtures.rect_chain(CHAIN["rectangles"])
    sketch = mod.plain(CHAIN)
    # The same guesses, up to the order of the additions.
    np.testing.assert_allclose(sketch.guess, x0, rtol=0, atol=1e-12)
    assert [c.lower() for c in cons] == [r.constraint.lower()
                                         for r in mod.port_requests(CHAIN)]


def _lowered_plain(sketch):
    """The reference's plain rows as the program lowers them."""
    from portbench.reference import lm

    out = []
    for kind, ids, p in zip(sketch.kinds, sketch.ids, sketch.params):
        if kind == lm.FIXED:
            out.append(("fixed", (int(ids[0]),), (float(p),)))
        elif kind == lm.HORIZONTAL:
            out.append(("horizontal", (int(ids[1]), int(ids[3])), ()))
        elif kind == lm.VERTICAL:
            out.append(("vertical", (int(ids[0]), int(ids[2])), ()))
        else:
            out.append(("distance", tuple(int(i) for i in ids), (float(p),)))
    return out


@pytest.mark.parametrize("name,cfg,vary", [("massive_lines", MASSIVE, False),
                                           ("massive_lines", MASSIVE, True),
                                           ("rect_chain", CHAIN, False),
                                           ("rect_chain", CHAIN, True)])
def test_program_and_reference_get_the_same_constraints(name, cfg, vary):
    import torch

    mod = harness.module("sketches", name)
    sketch = mod.plain(cfg)
    params, _guesses = mod.lanes(cfg, sketch, 2, vary, torch.Generator().manual_seed(1),
                                 "cpu")
    row = params[0].numpy()
    got = [(i.kernel, tuple(i.var_ids), tuple(i.params))
           for r in mod.port_requests(cfg, row) for i in r.constraint.lower()]
    want = _lowered_plain(type(sketch)(sketch.kinds, sketch.ids, row, sketch.guess))
    assert got == want


def test_lanes_are_drawn_from_the_seed():
    import torch

    mod = harness.module("sketches", "rect_chain")
    sketch = mod.plain(CHAIN)
    a = mod.lanes(CHAIN, sketch, 4, True, torch.Generator().manual_seed(2**40), "cpu")
    b = mod.lanes(CHAIN, sketch, 4, True, torch.Generator().manual_seed(2**40), "cpu")
    c = mod.lanes(CHAIN, sketch, 4, True, torch.Generator().manual_seed(2**40 + 1), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    lo, hi = CHAIN["variants"]["distance_scale"]
    widths = a[0][:, 6::6] / CHAIN["width"]
    assert bool(((widths >= lo) & (widths <= hi)).all())
