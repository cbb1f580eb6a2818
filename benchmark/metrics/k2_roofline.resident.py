"""k2_roofline.resident (ops: K2, mapping.depth_refinement): K2's least
time for N windows (workcount.lm_bytes) over its mean device time a
launch in the profiled dispatches, in %."""
import devtrace as T
from workcount import bound_s, lm_bytes, lm_window


def read(trace: dict):
    ops = trace.get("ops")
    if not ops:
        return None
    t, n = T.kernel_s(ops, "lm_kernel<")
    if n == 0 or t <= 0:
        return None
    Wy, Wx = lm_window(*trace["lm_window"])
    return 100.0 * bound_s(lm_bytes(trace["lm_events"], Wy, Wx), 0) / (t / n)
