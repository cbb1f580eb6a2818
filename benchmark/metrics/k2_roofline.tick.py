"""k2_roofline.tick (ops: K2, mapping.depth_refinement): K2's least time
for N windows (workcount.lm_bytes) over its device time a launch on the
profiled mapping ticks, in %."""
from workcount import bound_s, lm_bytes, lm_window


def read(trace: dict):
    launches = [t["k2"] for t in trace.get("ticks", ()) if t["k2"][1]]
    if not launches:
        return None
    t = sum(s for s, _ in launches) / sum(n for _, n in launches)
    Wy, Wx = lm_window(*trace["lm_window"])
    return 100.0 * bound_s(lm_bytes(trace["lm_events"], Wy, Wx), 0) / t
