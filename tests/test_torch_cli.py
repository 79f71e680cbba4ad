"""The port's CLI (``python -m ezpz_tpu_torch.cli``) against ``ezpz_tpu.cli``.

Both run in this process with ``--cpu`` on the same arguments and input;
their standard output must be equal line for line except the timing lines
(``Solved in``, ``i.e. ... solves per second``), and their exit codes and
error lines equal. The PNG is drawn only where matplotlib imports.
"""

import io
import os

import pytest

import ezpz_tpu
from ezpz_tpu import cli as jcli
from ezpz_tpu_torch import cli as tcli

from .helpers import CASES_DIR

TIMING = ("Solved in ", "i.e. ")


def _run(capsys, monkeypatch, module, args, stdin=None):
    # The JAX CLI turns on its persistent compilation cache under $HOME;
    # the tests keep the one their conftest chose.
    monkeypatch.setattr(ezpz_tpu, "enable_compilation_cache", lambda *a, **k: None)
    if stdin is not None:
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    rc = module.main(["--cpu", *args])
    out = capsys.readouterr()
    return rc, out.out.splitlines(), out.err.splitlines()


def _both(capsys, monkeypatch, args, stdin=None):
    j = _run(capsys, monkeypatch, jcli, args, stdin)
    t = _run(capsys, monkeypatch, tcli, args, stdin)
    assert t[0] == j[0]
    assert ([l for l in t[1] if not l.startswith(TIMING)]
            == [l for l in j[1] if not l.startswith(TIMING)])
    assert [l.startswith(TIMING) for l in t[1]] == [l.startswith(TIMING) for l in j[1]]
    return t


def _case(name):
    return os.path.join(CASES_DIR, name, "problem.md")


def test_cli_tiny(capsys, monkeypatch):
    rc, out, _err = _both(capsys, monkeypatch, ["-f", _case("tiny")])
    assert rc == 0
    assert "Problem size: 4 rows, 4 vars" in out
    assert "Iterations needed: 1" in out
    assert any(l.endswith("solves per second") for l in out)


def test_cli_stdin(capsys, monkeypatch):
    with open(_case("tiny")) as fh:
        txt = fh.read()
    rc, out, _err = _both(capsys, monkeypatch, ["-f", "-"], stdin=txt)
    assert rc == 0 and "Problem size: 4 rows, 4 vars" in out


def test_cli_parse_error(capsys, monkeypatch):
    rc, _out, err = _both(capsys, monkeypatch, ["-f", "-"],
                          stdin="# constraints\nbogus(p)\n\n# guesses\np roughly (0,0)\n")
    assert rc == 1
    assert any("Error" in l for l in err)


def test_cli_show_points_and_png(capsys, monkeypatch, tmp_path):
    args = ["-f", _case("arc_radius"), "--show-points"]
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        png = None
    else:
        png = str(tmp_path / "out.png")
        args += ["--image-path", png]
    rc, out, _err = _both(capsys, monkeypatch, args)
    assert rc == 0
    assert "Problem size: 4 rows, 8 vars" in out and "Arcs:" in out
    if png is not None:
        assert os.path.getsize(png) > 1000


def test_cli_profile_writes_a_trace(capsys, monkeypatch, tmp_path):
    rc, out, _err = _run(capsys, monkeypatch, tcli,
                         ["-f", _case("tiny"), "--profile", str(tmp_path / "prof")])
    assert rc == 0
    assert f"Profiler trace written to {tmp_path / 'prof'}/" in out
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def test_cli_without_a_card_fails(capsys):
    """Without ``--cpu`` the CLI solves on the GPU; here, without one, it
    exits 1 with the reason instead of solving on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    rc = tcli.main(["-f", _case("tiny")])
    err = capsys.readouterr().err
    assert rc == 1 and "device='cpu'" in err
