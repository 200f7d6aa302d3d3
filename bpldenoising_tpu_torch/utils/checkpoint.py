"""Checkpoint and resume of the outer bilevel loop (counterpart of
``bpldenoising_tpu.utils.checkpoint``).

An ``.npz`` snapshot of (x, Δ, the dense BFGS matrix, the log rows) after
an accepted outer iteration, and its loader.  The keys (``x``, ``delta``,
``B``, ``log``, ``iteration``) and the layout are the JAX package's, so
either package reads the other's checkpoints.  NumPy only: the loop state
is on the host when it is saved.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointWriter"]


def save_checkpoint(path: str, *, x, delta: float, B=None, log_rows=None,
                    iteration: int = 0) -> None:
    """Write the snapshot to ``path`` atomically (a temporary file, then
    ``os.replace``).  ``log_rows`` is (n, 6): iter, time, cost, ‖g‖, Δ,
    ‖step‖; ``B=None`` stores an empty array."""
    tmp = path + ".tmp"   # np.savez appends ".npz" to this name
    np.savez(
        tmp,
        x=np.asarray(x),
        delta=np.asarray(delta),
        B=np.asarray(B) if B is not None else np.zeros(0),
        log=np.asarray(log_rows if log_rows is not None else np.zeros((0, 6))),
        iteration=np.asarray(iteration),
    )
    os.replace(tmp + ".npz", path)


def load_checkpoint(path: str) -> Optional[dict]:
    """The snapshot at ``path`` as a dict of arrays (``B`` None where none
    was stored), or None when there is no file."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    if out.get("B") is not None and out["B"].size == 0:
        out["B"] = None
    return out


class CheckpointWriter:
    """The ``checkpoint`` callback of
    :func:`..bilevel.trust_region.bilevel_learn`: ``writer(iteration, x,
    delta, log, B=None)`` saves the snapshot to ``path``, the log entries as
    rows."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def __call__(self, iteration, x, delta, log, B=None):
        rows = None
        if log:
            rows = np.asarray([
                [e.iter, e.time, e.function_value, e.g_norm, e.delta,
                 e.step_norm] for e in log])
        save_checkpoint(self.path, x=x, delta=delta, B=B, log_rows=rows,
                        iteration=iteration)
