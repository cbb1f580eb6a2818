"""Timing and profiling helpers (port of esvo_tpu/utils/profiling.py).

The reference wraps every stage in a TicToc wall-clock stopwatch
(esvo_core/include/esvo_core/tools/TicToc.h:15-35) and logs percentages.
Here: the same stopwatch, a per-stage accumulator, a thin wrapper over
``torch.profiler`` for device traces (in place of jax.profiler), and the
program's tracer.

The tracer records named spans and counters where the program works
(PERF.md section 3 lists every name). It is off by default, and then
``span`` is one test of a module flag that returns a shared null
context. ``enable()`` turns it on for the process:

- ``span(name, **attrs)`` records its name, attributes, enclosing span
  (``parent``), the running number of its root span (``id``; a root is
  a span opened while no other is open: a tick, a dispatch)
  and its start and end on ``time.perf_counter_ns()``. While a
  ``torch.profiler`` is active it also enters
  ``torch.profiler.record_function(name)``, so the span lies in the
  profiler's trace on the same clock as the card's kernels;
- ``device_span(name)`` puts a pair of timing CUDA events on the current
  stream around a block (nothing while the stream is capturing a graph,
  nothing without CUDA), read back as ms at ``take()``;
- ``count(name, n)`` keeps running totals, and each root span keeps the
  increments made inside it (``counts``), so a counter reads per tick.

``take()`` returns what was recorded since the last ``take`` and clears
it; ``export`` writes that as a Chrome trace and a ``StageTimer``
summary. Spans nest in the order they open and close: the program opens
them from one thread.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import time

import torch

_on = False
_open: list = []           # the open host spans, outermost first
_records: list = []
_totals: collections.Counter = collections.Counter()
_root_ids = itertools.count()


class _NullSpan:
    """What ``span`` and ``device_span`` return with the tracer off: it
    enters and leaves doing nothing and drops attributes."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Span:
    """One host span; ``keep`` False times the block without recording
    it (``StageTimer`` with the tracer off)."""
    __slots__ = ("name", "attrs", "parent", "id", "counts", "start_ns",
                 "end_ns", "_keep", "_annotation")

    def __init__(self, name: str, attrs: dict, keep: bool = True):
        self.name, self.attrs, self._keep = name, attrs, keep
        self.parent = self.counts = self._annotation = None

    def set(self, **attrs) -> None:
        """Add attributes known only once the block has run."""
        self.attrs.update(attrs)

    def __enter__(self):
        if self._keep:
            if _open:
                self.parent, self.id = _open[-1].name, _open[-1].id
            else:
                self.id, self.counts = next(_root_ids), {}
            _open.append(self)
            if torch._C._autograd._profiler_enabled():
                self._annotation = torch.profiler.record_function(self.name)
                self._annotation.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._keep:
            if self._annotation is not None:
                self._annotation.__exit__(*exc)
            _open.pop()
            _records.append(self)
        return False

    def record(self) -> dict:
        out = dict(name=self.name, attrs=self.attrs, parent=self.parent,
                   id=self.id, start_ns=self.start_ns, end_ns=self.end_ns)
        if self.counts is not None:
            out["counts"] = self.counts
        return out


class _DeviceSpan:
    """Timing CUDA events around a block on the current stream."""
    __slots__ = ("name", "parent", "id", "_start", "_end")

    def __init__(self, name: str):
        self.name = name
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        self.parent = _open[-1].name if _open else None
        self.id = _open[-1].id if _open else None
        self._start.record()
        return self

    def __exit__(self, *exc):
        self._end.record()
        _records.append(self)
        return False

    def record(self) -> dict:
        self._end.synchronize()
        return dict(name=self.name, parent=self.parent, id=self.id,
                    device_ms=self._start.elapsed_time(self._end))


def enable() -> None:
    """Record spans and counters from now on (until ``disable``)."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays for ``take``."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str, **attrs):
    """A context manager that records the block as a span (see the module
    docstring); the shared ``NULL_SPAN`` while the tracer is off. Both
    take attributes known only later through ``.set(**attrs)``."""
    if not _on:
        return NULL_SPAN
    return _Span(name, attrs)


def device_span(name: str):
    """A context manager that times the block on the card's current
    stream; records nothing with the tracer off, without CUDA or while
    the stream is capturing a CUDA graph."""
    if (not _on or not torch.cuda.is_initialized()
            or torch.cuda.is_current_stream_capturing()):
        return NULL_SPAN
    return _DeviceSpan(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` (and to the open root span's
    increments)."""
    if not _on:
        return
    _totals[name] += n
    if _open:
        counts = _open[0].counts
        counts[name] = counts.get(name, 0) + n


def take() -> dict:
    """The records since the last ``take``, cleared: ``{"spans": [...],
    "counters": {name: total}}``. A host span is ``{name, attrs, parent,
    id, start_ns, end_ns}``, a root's with ``counts``; a device span is
    ``{name, parent, id, device_ms}`` (this waits for its end event).
    Spans still open are recorded when they close."""
    global _records, _totals
    records, _records = _records, []
    totals, _totals = _totals, collections.Counter()
    return {"spans": [r.record() for r in records],
            "counters": dict(totals)}


def export(records: dict, out_dir: str) -> str:
    """Write ``take()``'s records to `out_dir`: ``spans.json``, a Chrome
    trace of the host spans (open it in Perfetto or chrome://tracing; a
    root's counter increments are in its args, the totals under
    ``otherData``), and ``summary.txt``, the time in each span name in
    ``StageTimer``'s format (device spans as ``<name> (device)``) and the
    counters' totals. Returns the summary."""
    os.makedirs(out_dir, exist_ok=True)
    pid = os.getpid()
    timer = StageTimer()
    events = []
    for r in records["spans"]:
        if "device_ms" in r:
            timer.totals[f"{r['name']} (device)"] += r["device_ms"] * 1e-3
            timer.counts[f"{r['name']} (device)"] += 1
            continue
        dur_ns = r["end_ns"] - r["start_ns"]
        timer.totals[r["name"]] += dur_ns * 1e-9
        timer.counts[r["name"]] += 1
        args = dict(r["attrs"], id=r["id"])
        if "counts" in r:
            args["counts"] = r["counts"]
        events.append(dict(name=r["name"], ph="X", ts=r["start_ns"] / 1e3,
                           dur=dur_ns / 1e3, pid=pid, tid=0, args=args))
    events.sort(key=lambda e: e["ts"])
    with open(os.path.join(out_dir, "spans.json"), "w") as f:
        json.dump({"traceEvents": events,
                   "otherData": {"counters": records["counters"]}}, f,
                  default=str)
    summary = timer.summary()
    if records["counters"]:
        summary += "\n" + "\n".join(
            f"{name:>24}: {n}" for name, n in sorted(
                records["counters"].items()))
    with open(os.path.join(out_dir, "summary.txt"), "w") as f:
        f.write(summary + "\n")
    return summary


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
    the reference's mapping-loop logs (esvo_Mapping.cpp:405-430). Each
    stage is timed as a span of the tracer, and recorded as one while the
    tracer is on. Host clocks with no synchronize: on the card a stage
    times what the host enqueued, unless it ends by waiting."""

    def __init__(self):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        sp = _Span(name, {}, keep=_on)
        try:
            with sp:
                yield
        finally:
            self.totals[name] += (sp.end_ns - sp.start_ns) * 1e-9
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
    profiler, whose ``key_averages()`` sums time by kernel. The tracer's
    spans opened inside appear in it as ``record_function`` ranges."""
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
