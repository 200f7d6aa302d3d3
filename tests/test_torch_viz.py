"""The port's viz layer (bpldenoising_tpu_torch viz/ and
bilevel/harness.py::LiveView): the cases of the JAX package's
tests/test_viz.py run against the port — the cost plots are written, the
log round-trips, and the live view renders on its own thread through a
depth-1 latest-frame channel that never blocks the iteration, drains its
last frame on close, survives a failing renderer and restarts after
close."""

import os
import time

import numpy as np
import pytest

from bpldenoising_tpu_torch.bilevel.harness import LiveView
from bpldenoising_tpu_torch.viz import (BilevelLogEntry, IterLog,
                                        plot_cost_contour, plot_cost_curve,
                                        write_log)


def test_plot_cost_curve(tmp_path):
    pytest.importorskip("matplotlib")
    base = str(tmp_path / "curve")
    plot_cost_curve(np.logspace(-3, 0, 10), np.linspace(5, 1, 10), base)
    assert os.path.exists(base + ".png")
    assert os.path.getsize(base + ".png") > 1000


def test_plot_cost_contour(tmp_path):
    pytest.importorskip("matplotlib")
    base = str(tmp_path / "contour")
    r = np.logspace(-3, -1, 5)
    costs = np.add.outer(np.arange(5.0), np.arange(5.0))
    plot_cost_contour(r, r, costs, base)
    assert os.path.exists(base + ".png")


def test_write_log_roundtrip(tmp_path):
    log = IterLog()
    log.append(BilevelLogEntry(1, 0.5, 10.0, 2.0, 0.1, 0.01))
    log.append(BilevelLogEntry(2, 1.0, 9.0, 1.5, 0.05, 0.02))
    path = str(tmp_path / "perf.txt")
    write_log(path, log, header="# test header")
    lines = open(path).read().splitlines()
    assert lines[0] == "# test header"
    assert lines[1].startswith("# iter")
    assert len(lines) == 4
    fields = lines[2].split("\t")
    assert int(fields[0]) == 1
    assert float(fields[2]) == 10.0


def test_liveview_headless_is_safe():
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    view = LiveView()
    # the Agg backend: nothing to draw on, and nothing raises
    view.show(np.zeros((8, 8)), None)
    view.show(np.zeros((3, 8, 8)), np.ones((2, 2)))
    view.close()
    assert view.frames_drawn >= 1


class TestAsyncLiveView:
    def test_slow_renderer_does_not_block_iteration(self):
        drawn = []

        def slow(image, param):
            time.sleep(0.15)
            drawn.append(np.asarray(image)[0, 0])

        view = LiveView(renderer=slow)
        t0 = time.perf_counter()
        for i in range(8):
            view.show(np.full((4, 4), float(i)), None)
        enqueue_time = time.perf_counter() - t0
        # 8 frames of a 0.15 s renderer would take 1.2 s in line; the
        # enqueues return at once
        assert enqueue_time < 0.1
        view.close()
        # the latest frame replaces a pending one, and the last frame is
        # drawn on close
        assert 1 <= len(drawn) <= 4
        assert drawn[-1] == 7.0
        assert view.frames_dropped >= 4
        assert view.frames_drawn == len(drawn)

    def test_fast_renderer_draws_everything(self):
        drawn = []
        view = LiveView(renderer=lambda im, p: drawn.append(im[0, 0]))
        for i in range(5):
            view.show(np.full((4, 4), float(i)), None)
            time.sleep(0.02)
        view.close()
        assert drawn[-1] == 4.0 and len(drawn) >= 4

    def test_renderer_exception_does_not_kill_run(self):
        def boom(image, param):
            raise RuntimeError("display fell over")

        view = LiveView(renderer=boom)
        view.show(np.zeros((4, 4)), None)
        view.close()   # joins cleanly; no exception propagates
        assert view.frames_drawn >= 1

    def test_show_after_close_is_noop(self):
        drawn = []
        view = LiveView(renderer=lambda im, p: drawn.append(1))
        view.show(np.zeros((4, 4)), None)
        view.close()
        n = len(drawn)
        # a fresh show() restarts the pump (close resets the stop flag)
        view.show(np.zeros((4, 4)), None)
        view.close()
        assert len(drawn) == n + 1
