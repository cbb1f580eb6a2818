"""map_tick_idle (device): 1 - the median device busy time of the
profiled mapping ticks over the median wall of the window's mapping
ticks (unprofiled, earlier in the same process), in %."""
import numpy as np


def read(trace: dict):
    busy = [t["busy_s"] for t in trace.get("ticks", ()) if t["mapped"]]
    wall = trace.get("map_tick_wall_s")
    if not busy or min(busy) <= 0 or not wall:
        return None
    return 100.0 * (1.0 - float(np.median(busy)) / wall)
