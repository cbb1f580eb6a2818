"""kernels_per_tick (runtime.resident): device operation records
(kernels, copies, sets) of the profiled dispatches, over their ticks."""


def read(trace: dict):
    ops, ticks = trace.get("ops"), trace.get("profiled_ticks")
    if not ops or not ticks:
        return None
    return len(ops) / ticks
