"""launches_per_map_tick (runtime.system): device operation records of a
profiled mapping tick, the median over those ticks."""
import numpy as np


def read(trace: dict):
    n = [t["launches"] for t in trace.get("ticks", ()) if t["mapped"]]
    return float(np.median(n)) if n and min(n) > 0 else None
