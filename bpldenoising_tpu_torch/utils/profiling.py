"""Profiler traces and section timing (counterpart of
``bpldenoising_tpu.utils.profiling``).

:func:`trace` wraps a region in a ``torch.profiler`` trace and writes it
as a Chrome trace (``trace.json``, viewable in Perfetto or
``chrome://tracing``); :class:`SectionTimer` accumulates wall time by
section name, waiting for the device at each section's end so that
device work is charged to the section that queued it.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

__all__ = ["trace", "SectionTimer"]


@contextlib.contextmanager
def trace(log_dir: str | None) -> Iterator[None]:
    """Profile the region when ``log_dir`` is set (a no-op otherwise): CPU
    activity, and CUDA activity (kernels and copies) when CUDA is
    available; the trace goes to ``<log_dir>/trace.json``::

        with trace("/tmp/bpl_trace"):
            run_experiment()
    """
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _synchronize(holder) -> None:
    """Wait for the CUDA devices of the tensors in ``holder`` (a tensor or a
    nest of tuples, lists and dicts of them)."""
    if isinstance(holder, torch.Tensor):
        if holder.is_cuda:
            torch.cuda.synchronize(holder.device)
    elif isinstance(holder, dict):
        for v in holder.values():
            _synchronize(v)
    elif isinstance(holder, (tuple, list)):
        for v in holder:
            _synchronize(v)


class SectionTimer:
    """Accumulating named-section timer that waits at each section's end
    for the CUDA device of ``result_holder``'s tensors."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, result_holder=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if result_holder is not None:
                _synchronize(result_holder)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"{name:30s} {self.totals[name]*1e3:10.2f} ms "
                         f"(n={self.counts[name]})")
        return "\n".join(lines)
