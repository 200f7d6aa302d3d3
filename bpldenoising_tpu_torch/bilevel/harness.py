"""The outer-iteration harness and what the bilevel learns return
(counterparts of ``bpldenoising_tpu.bilevel.harness`` and of
``bpldenoising_tpu.bilevel.trust_region.BilevelResult``).

:func:`bilevel_iterate` runs a step function with the JAX harness's
observable rules: it logs every iteration while iter ≤ 20, every 10th
while ≤ 200, then every ``verbose_iter``-th; the clock starts after the
first iteration of the run, and the time spent logging (``wasted_time``)
is taken out of every logged time; it stops when the radius Δ falls below
``params.tol``, when the step asks to, or on Ctrl-C (``interrupted``).

With ``visualise=True`` each logged iterate goes to a :class:`LiveView`
(the reconstruction and, for patch parameters, the normalised parameter
map), which draws on a thread of its own and never holds the iteration
up.
"""

from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from ..viz.log import BilevelLogEntry, IterLog

__all__ = ["BilevelState", "BilevelResult", "bilevel_iterate", "LiveView"]


class LiveView:
    """Live view of the current reconstruction and (for patch parameters)
    the normalised parameter map.

    Frames go to a render thread through a depth-1 channel: :meth:`show`
    never blocks; a frame still pending when the next arrives is replaced
    (counted in ``frames_dropped``), so the view shows the newest iterate.
    ``renderer(image, param)`` may be injected; the default draws with
    matplotlib and does nothing on a headless (agg) backend.  An exception
    in the renderer never stops a run.  A GUI backend that must draw on
    the main thread needs a renderer that hands the frame to its event
    loop."""

    def __init__(self, renderer: Optional[Callable] = None):
        self._renderer = renderer if renderer is not None else self._draw
        self._cond = threading.Condition()
        self._frame = None          # the pending frame (depth-1 channel)
        self._stopping = False
        self._thread = None
        self._fig = None
        self.frames_drawn = 0
        self.frames_dropped = 0

    def show(self, image: np.ndarray, param: Optional[np.ndarray]):
        """Queue the newest frame (replacing a pending one) and start the
        render thread if it is not running."""
        frame = (np.asarray(image),
                 None if param is None else np.asarray(param))
        with self._cond:
            if self._stopping:
                return
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._pump, name="bpldenoising-liveview",
                    daemon=True)
                self._thread.start()
            if self._frame is not None:
                self.frames_dropped += 1
            self._frame = frame
            self._cond.notify()

    def _pump(self):
        while True:
            with self._cond:
                while self._frame is None and not self._stopping:
                    self._cond.wait()
                if self._frame is None:     # stopping, nothing pending
                    return
                frame, self._frame = self._frame, None
            try:
                self._renderer(*frame)
            except Exception:
                pass  # a failing view must not end the run
            self.frames_drawn += 1

    def _draw(self, image: np.ndarray, param: Optional[np.ndarray]):
        import matplotlib
        import matplotlib.pyplot as plt
        if self._fig is None:
            if matplotlib.get_backend().lower() == "agg":
                return  # headless: nothing to draw on
            plt.ion()
            self._fig = plt.figure("bpldenoising")
        self._fig.clf()
        ncols = 1 + (param is not None)
        ax = self._fig.add_subplot(1, ncols, 1)
        if image.ndim == 3:  # planar (C, M, N) color → HWC for imshow
            image = np.clip(np.moveaxis(image, 0, -1), 0.0, 1.0)
        ax.imshow(image, cmap="gray")
        ax.set_title("reconstruction")
        ax.axis("off")
        if param is not None:
            ax2 = self._fig.add_subplot(1, ncols, 2)
            ax2.imshow(param, cmap="gray")
            ax2.set_title("parameter")
            ax2.axis("off")
        self._fig.canvas.draw_idle()
        self._fig.canvas.flush_events()

    def close(self):
        """Draw a pending frame (the last iterate stays on screen), join
        the render thread, and let a later :meth:`show` start again."""
        with self._cond:
            self._stopping = True
            self._cond.notify()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._stopping = False
        if self._fig is not None:
            try:
                import matplotlib.pyplot as plt
                plt.close(self._fig)
            except Exception:
                pass
            self._fig = None


@dataclass
class BilevelState:
    """Harness state returned with a learn: the outer-iteration log."""
    log: IterLog = field(default_factory=IterLog)
    start_time: Optional[float] = None
    wasted_time: float = 0.0
    interrupted: bool = False
    view: Optional[LiveView] = None


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
    st = state if state is not None else BilevelState()
    if visualise:
        st.view = LiveView()
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
                if st.view is not None or save_iteration_fn is not None:
                    image = _host(image)
                if st.view is not None:
                    xa = np.asarray(x)
                    pmap = None
                    if xa.ndim >= 2:  # patch parameters: a normalised map
                        lo, hi = xa.min(), xa.max()
                        pmap = (xa - lo) / (hi - lo) if hi > lo else xa * 0
                        pmap = pmap.reshape(pmap.shape[0], -1)
                    st.view.show(image, pmap)
                if save_iteration_fn is not None:
                    save_iteration_fn(_it, image)
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
    if st.view is not None:
        st.view.close()
    return st
