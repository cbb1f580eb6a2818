"""k4_roofline.resident (ops: K4, tracking.registration): the least time
of one K4 launch on the tracker's inputs (workcount.track_work: the
selected points, valid ones first, and the tracker's batch and rounds)
over K4's mean device time a launch in the profiled dispatches, in %."""
import devtrace as T
from workcount import bound_s, track_work


def read(trace: dict):
    ops = trace.get("ops")
    if not ops:
        return None
    t, n = T.kernel_s(ops, "track_solve_kernel")
    if n == 0 or t <= 0:
        return None
    nbytes, flops = track_work(trace["track_points"], trace["track_valid"],
                               trace["track_batch"], trace["track_rounds"])
    return 100.0 * bound_s(nbytes, flops) / (t / n)
