"""Timing and profiling helpers (port of esvo_tpu/utils/profiling.py).

The reference wraps every stage in a TicToc wall-clock stopwatch
(esvo_core/include/esvo_core/tools/TicToc.h:15-35) and logs percentages.
Here: the same stopwatch, a per-stage accumulator, and a thin wrapper
over ``torch.profiler`` for device traces (in place of jax.profiler).
"""
from __future__ import annotations

import collections
import contextlib
import os
import time


class TicToc:
    """Wall-clock ms stopwatch (reference TicToc.h:15-35)."""

    def __init__(self):
        self.tic()

    def tic(self) -> None:
        self._start = time.perf_counter()

    def toc(self) -> float:
        return (time.perf_counter() - self._start) * 1e3


class StageTimer:
    """Accumulates per-stage wall time; prints a percentage breakdown like
    the reference's mapping-loop logs (esvo_Mapping.cpp:405-430)."""

    def __init__(self):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> str:
        total = sum(self.totals.values()) or 1e-12
        lines = []
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:>24}: {t * 1e3:9.2f} ms "
                         f"({100 * t / total:5.1f}%) "
                         f"x{self.counts[name]}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace (CPU and, where there is a card, CUDA
    activity) around a block, written to `log_dir` as a Chrome trace
    (``trace.json``; open it in chrome://tracing or Perfetto). Yields the
    profiler, whose ``key_averages()`` sums time by kernel."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
