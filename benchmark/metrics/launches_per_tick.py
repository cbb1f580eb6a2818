"""launches_per_tick (runtime.system): device operation records of a
profiled tick with no mapping cycle, the median over those ticks."""
import numpy as np


def read(trace: dict):
    n = [t["launches"] for t in trace.get("ticks", ()) if not t["mapped"]]
    return float(np.median(n)) if n and min(n) > 0 else None
