"""Native (C++) host-side components of the port.

The counterpart of ``ezpz_tpu/native``: the same two CPython extensions,
from copies of the same sources, built with g++ on first use, with Python
fallbacks when no toolchain is available:

* ``fastparse``  — the textual-format parser (the grammar of
  ``textual/parser.py``, ~20x faster);
* ``fastdecomp`` — union-find connected components over flat constraint
  buffers (``models/blocks.connected_components``).

They build into ``build/ezpz_tpu_torch/native/`` under the repository root
(not beside the sources) and load as ``ezpz_tpu_torch.native._<name>``, so
a process that also loads the JAX package's modules keeps both apart.
Neither extension imports anything of ``torch`` or of the JAX package.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import Optional

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ezpz_tpu_torch" / "native"
_cache: dict = {}
# Guards first-use compilation + dlopen: concurrent threads (the HTTP
# service) must not race two g++ processes onto the same .so or dlopen a
# half-written file (which would cache a spurious None forever).
_lock = threading.Lock()


def _so_path(name: str) -> Path:
    tag = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"_{name}{tag}"


def build(name: str = "fastparse", verbose: bool = False) -> Optional[str]:
    """Compile one extension; returns the .so path or None on failure."""
    src = SRC_DIR / f"{name}.cpp"
    so = _so_path(name)
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return str(so)
    include = sysconfig.get_paths()["include"]
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    # Compile to a per-process temporary and os.replace() it into place:
    # the threading lock only serializes threads in THIS process, and two
    # processes (several pytest/serve workers on a fresh checkout) racing
    # g++ onto the same path could dlopen a half-written .so.
    tmp = f"{so}.tmp.{os.getpid()}"
    cmd = [
        "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
        f"-I{include}", str(src), "-o", tmp,
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if res.returncode != 0:
        if verbose:
            sys.stderr.write(res.stderr)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    os.replace(tmp, so)  # atomic on POSIX: the .so appears fully written
    return str(so)


def _load(name: str):
    """The compiled module, or None (callers use their Python fallback)."""
    if name in _cache:
        return _cache[name]
    with _lock:
        if name in _cache:  # built while we waited
            return _cache[name]
        mod = None
        so = build(name)
        if so is not None:
            try:
                spec = importlib.util.spec_from_file_location(
                    f"ezpz_tpu_torch.native._{name}", so
                )
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)  # type: ignore[union-attr]
            except Exception:
                mod = None
        _cache[name] = mod
        return mod


def load_fastparse():
    return _load("fastparse")


def load_fastdecomp():
    return _load("fastdecomp")


if __name__ == "__main__":
    for name in ("fastparse", "fastdecomp"):
        print(name, "->", build(name, verbose=True))
