"""The port's examples (``ezpz_tpu_torch/examples``) run with ``--cpu`` and
print the lines ``tests/test_examples.py`` checks for the JAX package's
``examples/``."""

import pytest

from ezpz_tpu_torch.examples import basic, parser, scale

CASES = {
    "basic": (basic, ["|PQ| = 4.000000000"]),
    "parser": (parser, ["p = (0.000000, 0.000000)"]),
    "scale": (scale, ["fleet: 4096 sketches, all converged = True",
                      "converged = True, all line lengths = 4.000000"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(name, capsys):
    module, lines = CASES[name]
    module.main(["--cpu"])
    out = capsys.readouterr().out
    for line in lines:
        assert line in out, out
