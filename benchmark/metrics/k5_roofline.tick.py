"""k5_roofline.tick (ops: K5, mapping.regularization): K5's least time on
the grid it was given (valid centres and close pairs, recomputed by the
reference from the same tick; workcount.regularize_work) over its
device time on that tick, in %, the median over the profiled mapping
ticks."""
import numpy as np

from workcount import bound_s, regularize_work


def read(trace: dict):
    shares = []
    mapped = [t for t in trace.get("ticks", ()) if t["mapped"]]
    for tick, work in zip(mapped, trace.get("k5_work", ())):
        t, n = tick["k5"]
        if n != 1 or t <= 0 or not work:
            continue
        nbytes, flops = regularize_work(work["valid"], work["pairs"],
                                        trace["k5_radius"], work["H"],
                                        work["W"], trace["k5_tdist"])
        shares.append(100.0 * bound_s(nbytes, flops) / t)
    return float(np.median(shares)) if shares else None
