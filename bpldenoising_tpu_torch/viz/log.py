"""Outer-iteration log (counterpart of ``bpldenoising_tpu.viz.log``): one
:class:`BilevelLogEntry` per trust-region iteration, collected in an
:class:`IterLog`, and :func:`write_log`, which writes it as the JAX
package's whitespace-separated text: an optional header line, the column
line, one row per entry (the two adjoint-CG columns only when some entry
recorded them)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

__all__ = ["BilevelLogEntry", "IterLog", "write_log"]

_NAN = float("nan")


@dataclass
class BilevelLogEntry:
    iter: int
    time: float       # seconds, excluding logging (0.0 from the fused
    #                   loops: segmented dispatch is not ported)
    function_value: float
    g_norm: float
    delta: float      # trust-region radius
    step_norm: float  # ‖x − x̄‖ of the last accepted step
    # adjoint-CG telemetry; NaN = not recorded
    adjoint_cg_iters: float = _NAN
    adjoint_cg_converged: float = _NAN   # 1.0 / 0.0


class IterLog(List[BilevelLogEntry]):
    """Append-only log of the outer iterations."""


def write_log(path: str, log: IterLog, header: str = "") -> None:
    """Write ``log`` to ``path`` in the JAX package's text format."""
    with_cg = any(not math.isnan(e.adjoint_cg_iters) for e in log)
    with open(path, "w") as fh:
        if header:
            fh.write(header if header.endswith("\n") else header + "\n")
        cols = "# iter\ttime\tfunction_value\tg_norm\tdelta\tstep_norm"
        if with_cg:
            cols += "\tadjoint_cg_iters\tadjoint_cg_converged"
        fh.write(cols + "\n")
        for e in log:
            row = (f"{e.iter}\t{e.time:.6f}\t{e.function_value:.10e}\t"
                   f"{e.g_norm:.10e}\t{e.delta:.10e}\t{e.step_norm:.10e}")
            if with_cg:
                row += (f"\t{e.adjoint_cg_iters:.0f}"
                        f"\t{e.adjoint_cg_converged:.0f}")
            fh.write(row + "\n")
