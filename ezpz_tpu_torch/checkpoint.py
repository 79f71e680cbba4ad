"""Checkpoint/resume for long-running sharded solves.

The counterpart of ``ezpz_tpu/checkpoint.py`` (numpy only, copied: the port
imports nothing of the JAX package). The reference needs nothing here — a
solve is milliseconds and the textual problem file is the only persistence
(SURVEY.md section 5). For giant sharded systems, preemption mid-solve
matters, so ``parallel.ShardedSchurSolver.solve_checkpointed`` dumps the
full LM state — variable values, damping lambda, iteration counter,
degenerate flags — to an ``.npz`` after every few iterations (rank 0
writes) and resumes from it when re-launched (every rank reads).

A topology fingerprint guards against resuming onto a different system:
mismatched checkpoints are ignored (fresh start), never trusted.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Optional, Tuple

import numpy as np


def topology_fingerprint(*arrays: np.ndarray) -> str:
    """A stable hash of the solver's compiled layout."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def save_state(path: str, fingerprint: str, x_i: np.ndarray, x_b: np.ndarray,
               lam: float, it: int, deg: np.ndarray) -> None:
    """Atomic write: never leaves a half-written checkpoint behind."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                fingerprint=np.frombuffer(bytes.fromhex(fingerprint), dtype=np.uint8),
                x_i=np.asarray(x_i), x_b=np.asarray(x_b),
                lam=np.float64(lam), it=np.int64(it), deg=np.asarray(deg),
            )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(
    path: str, fingerprint: str
) -> Optional[Tuple[np.ndarray, np.ndarray, float, int, np.ndarray]]:
    """(x_i, x_b, lam, it, deg) or None (missing / corrupt / wrong topology)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            stored = bytes(z["fingerprint"].tobytes()).hex()
            if stored != fingerprint:
                return None
            return (
                np.asarray(z["x_i"]), np.asarray(z["x_b"]),
                float(z["lam"]), int(z["it"]), np.asarray(z["deg"]),
            )
    except Exception:
        return None  # unreadable checkpoint: start fresh, never crash
