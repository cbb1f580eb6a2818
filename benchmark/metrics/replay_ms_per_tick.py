"""replay_ms_per_tick (runtime.resident): CUDA events around every graph
replay of the traced window, summed, over the ticks replayed."""


def read(trace: dict):
    return trace.get("replay_ms_per_tick")
