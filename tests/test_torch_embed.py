"""The port's embedding probes (``ezpz_tpu_torch.embed``) against the JAX
package's (``ezpz_tpu.embed``), on the CPU: ``hello``, ``test_linalg``
through the port's ``spd_solve``, and ``benchmark``'s 14 values within
1e-9 of the JAX package's; the self-timed report runs; without a card the
default device raises."""

import numpy as np
import pytest
import torch

from ezpz_tpu import embed as jembed
from ezpz_tpu_torch import embed as tembed


def test_hello():
    assert tembed.hello() == 33 == jembed.hello()


def test_linalg_probe():
    assert tembed.test_linalg(device="cpu") == 1.0


def test_benchmark_matches_jax():
    vals = tembed.benchmark(device="cpu")
    assert len(vals) == 14
    np.testing.assert_allclose(vals, jembed.benchmark(), rtol=0, atol=1e-9)
    v = np.asarray(vals)
    # First rectangle: p0=(1,1), p1=(5,1), p2=(5,4), p3=(1,4).
    np.testing.assert_allclose(v[0:8], [1, 1, 5, 1, 5, 4, 1, 4], atol=1e-4)


def test_self_timed_report(capsys, monkeypatch):
    monkeypatch.setattr(tembed, "benchmark", lambda device=None: [0.0] * 14)
    assert tembed._main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert "hello() = 33, test_linalg() = 1.0, benchmark(): 14 values" in out
    assert "on cpu" in out


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: tests/test_torch_cuda.py covers it")
    for probe in (tembed.test_linalg, tembed.benchmark):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            probe()
