"""Outer-iteration log entries (counterpart of
``bpldenoising_tpu.viz.log``): one :class:`BilevelLogEntry` per trust-region
iteration, collected in an :class:`IterLog`.  Writing the log as text
(``write_log``) is not ported yet."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

__all__ = ["BilevelLogEntry", "IterLog"]

_NAN = float("nan")


@dataclass
class BilevelLogEntry:
    iter: int
    time: float       # seconds (0.0: segmented dispatch is not ported)
    function_value: float
    g_norm: float
    delta: float      # trust-region radius
    step_norm: float  # ‖x − x̄‖ of the last accepted step
    # adjoint-CG telemetry; NaN = not recorded
    adjoint_cg_iters: float = _NAN
    adjoint_cg_converged: float = _NAN   # 1.0 / 0.0


class IterLog(List[BilevelLogEntry]):
    """Append-only log of the outer iterations."""
