"""idle_outside_replays (device): the share of the traced window's wall
(unprofiled) outside the graph replays' spans by CUDA events, in %."""


def read(trace: dict):
    return trace.get("idle_outside_replays")
