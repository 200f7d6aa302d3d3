"""What the bilevel learns return to their callers (counterparts of
``bpldenoising_tpu.bilevel.harness.BilevelState`` and
``bpldenoising_tpu.bilevel.trust_region.BilevelResult``).

The live plot of the JAX harness is not ported: ``view`` stays ``None``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from ..viz.log import IterLog

__all__ = ["BilevelState", "BilevelResult"]


@dataclass
class BilevelState:
    """Harness state returned with a learn: the outer-iteration log."""
    log: IterLog = field(default_factory=IterLog)
    start_time: Optional[float] = None
    wasted_time: float = 0.0
    interrupted: bool = False
    view: Optional[Any] = None


@dataclass
class BilevelResult:
    x: np.ndarray          # learned parameter (original shape)
    u: np.ndarray          # reconstruction at x
    state: BilevelState    # harness state (log, timing)
    cost: float
    g_norm: float
    iterations: int
