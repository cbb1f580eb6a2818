"""Readings of a torch.profiler trace (CPU and CUDA activity) over a
stretch of a run: the device operations, the busy time, the harness's
own host spans (``record_function`` around the calls into the program)
and the breakdown the result line carries."""
from __future__ import annotations

import contextlib

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def profiled():
    """torch.profiler over a stretch; yields the profile."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


# the harness's host spans (record_function); the profiler also lists
# them among the device's events, which device_ops leaves out
SPANS = ("ResidentLoop.run", "ResidentLoop.sync", "process_tick",
         "synchronize")


def span(name: str):
    if name not in SPANS:
        raise ValueError(f"{name!r} is not one of the harness's spans")
    return record_function(name)


def device_ops(prof) -> list[tuple[str, float, float]]:
    """(name, start_us, end_us) of every device operation (kernels,
    copies, sets), by start."""
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and e.name not in SPANS]
    return sorted(out, key=lambda e: e[1])


def host_spans(prof, names) -> list[tuple[str, float, float]]:
    """(name, start_us, end_us) of the host spans named in `names`."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name in names]


def busy_s(ops) -> float:
    """Seconds in which a device operation ran (the union of their
    intervals)."""
    total, end = 0.0, float("-inf")
    for _, s, e in ops:
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e6


def kernel_s(ops, pattern: str) -> tuple[float, int]:
    """Device seconds and count of the operations whose name holds
    `pattern`."""
    hit = [e - s for name, s, e in ops if pattern in name]
    return sum(hit) / 1e6, len(hit)


def breakdown(groups, spans, top: int = 10) -> dict:
    """The device operations that took most time (by name), and the
    longest idle gaps between device operations inside each group of
    `groups` (lists of ops, one profiled stretch each), each gap named
    by the innermost host span around its middle."""
    by_name: dict = {}
    gaps = []
    for ops in groups:
        end = None
        for name, s, e in ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
    dev = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) / 2
        around = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        label = (min(around, key=lambda sp: sp[2] - sp[1])[0] if around
                 else "outside the harness's spans")
        named.append([label, (b - a) / 1e6])
    return dict(device_ops=[[n[:120], v] for n, v in dev], idle_gaps=named)
