"""The outer-iteration harness and what the bilevel learns return
(counterparts of ``bpldenoising_tpu.bilevel.harness`` and of
``bpldenoising_tpu.bilevel.trust_region.BilevelResult``).

:func:`bilevel_iterate` runs a step function with the JAX harness's
observable rules: it logs every iteration while iter ≤ 20, every 10th
while ≤ 200, then every ``verbose_iter``-th; the clock starts after the
first iteration of the run, and the time spent logging (``wasted_time``)
is taken out of every logged time; it stops when the radius Δ falls below
``params.tol``, when the step asks to, or on Ctrl-C (``interrupted``).

The live plot of the JAX harness (``LiveView``) is not ported:
``visualise=True`` raises and ``view`` stays ``None``.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from ..viz.log import BilevelLogEntry, IterLog

__all__ = ["BilevelState", "BilevelResult", "bilevel_iterate"]


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
    u: Any                 # reconstruction at x: a host array from the
    #                        entry points, a device tensor from bilevel_learn
    state: BilevelState    # harness state (log, timing)
    cost: float
    g_norm: float
    iterations: int


def _should_log(iteration: int, verbose_iter: int) -> bool:
    """Every iteration while iter ≤ 20, every 10th while ≤ 200, and every
    ``verbose_iter``-th; ``verbose_iter`` ≤ 0 logs nothing."""
    if verbose_iter <= 0:
        return False
    return (iteration <= 20
            or (iteration <= 200 and iteration % 10 == 0)
            or iteration % verbose_iter == 0)


def _host(image):
    """An image as a host array (a device tensor is read once)."""
    if hasattr(image, "detach"):
        return image.detach().cpu().numpy()
    return np.asarray(image)


def bilevel_iterate(step: Callable, params, visualise: bool = False,
                    save_iteration_fn: Optional[Callable] = None,
                    state: Optional[BilevelState] = None,
                    start_iteration: int = 0) -> BilevelState:
    """Run ``step(verbose)`` for up to ``params.maxiter`` iterations.

    ``step`` calls ``verbose(lambda: (x, image, fx, gnorm, delta,
    step_norm[, cg]))`` once per iteration, and the harness materialises
    the tuple only for the iterations it logs; ``cg`` is the optional
    ``{iters, converged, ...}`` of the last adjoint solve.  ``step``
    returns True to stop.  ``start_iteration`` continues the numbering of a
    resumed run (the budget stays ``maxiter`` in all).
    ``save_iteration_fn(iteration, image)`` gets each logged image as a
    host array.
    """
    if visualise:
        raise NotImplementedError(
            "visualise is not ported yet (ROADMAP.md §1 item 6)")
    st = state if state is not None else BilevelState()
    maxiter = int(params.maxiter)
    verbose_iter = int(params.get("verbose_iter", 1) or 0)
    tol = float(params.get("tol", 0.0))

    try:
        first_iter = int(start_iteration) + 1
        for iteration in range(first_iter, maxiter + 1):
            # the clock starts after this run's first iteration (warm-up:
            # the kernels' build and first launches); waste accrued before
            # it is not subtracted from later times
            if st.start_time is None and iteration > first_iter:
                st.start_time = time.perf_counter()
                st.wasted_time = 0.0

            stop = False

            def verbose(value_fn, _it=iteration):
                nonlocal stop
                if not _should_log(_it, verbose_iter):
                    return
                t0 = time.perf_counter()
                vals = value_fn()
                x, image, fx, gnorm, delta, step_norm = vals[:6]
                cg = vals[6] if len(vals) > 6 else None
                elapsed = (0.0 if st.start_time is None
                           else t0 - st.start_time - st.wasted_time)
                entry = BilevelLogEntry(
                    _it, elapsed, float(fx), float(gnorm), float(delta),
                    float(step_norm))
                if cg is not None:
                    entry.adjoint_cg_iters = float(cg["iters"])
                    entry.adjoint_cg_converged = float(cg["converged"])
                st.log.append(entry)
                print(f"{_it:4d}/{maxiter} f={float(fx):.6e} "
                      f"|g|={float(gnorm):.4e} Δ={float(delta):.4e} "
                      f"step={float(step_norm):.4e}",
                      file=sys.stderr, flush=True)
                if save_iteration_fn is not None:
                    save_iteration_fn(_it, _host(image))
                if float(delta) < tol:
                    stop = True
                st.wasted_time += time.perf_counter() - t0

            # the step may itself request a stop (Δ < tol), apart from
            # logging
            requested = step(verbose)
            if stop or requested:
                break
    except KeyboardInterrupt:
        st.interrupted = True
        print("interrupted — returning current state", file=sys.stderr,
              flush=True)
    return st
