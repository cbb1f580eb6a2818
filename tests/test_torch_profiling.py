"""The port's timing helpers (utils/profiling.py): TicToc and StageTimer
as the JAX package's, and device_trace on torch.profiler (a Chrome
trace written to the directory, the profiler handed to the block)."""
import json
import os
import time

import torch

from esvo_tpu.utils import profiling as jprof
from esvo_tpu_torch.utils.profiling import StageTimer, TicToc, device_trace


def test_tictoc_measures_ms():
    t = TicToc()
    time.sleep(0.02)
    ms = t.toc()
    assert 15.0 <= ms < 1000.0
    t.tic()
    assert t.toc() < ms


def test_stage_timer_summary_matches_jax_format():
    ours, theirs = StageTimer(), jprof.StageTimer()
    for timer in (ours, theirs):
        for name, n in (("render", 2), ("track", 1)):
            for _ in range(n):
                with timer.stage(name):
                    time.sleep(0.002)
    assert dict(ours.counts) == dict(theirs.counts) == {"render": 2,
                                                         "track": 1}
    lines = ours.summary().splitlines()
    assert len(lines) == 2 and lines[0].strip().startswith("render:")
    assert "x2" in lines[0] and "%" in lines[1]
    assert [l.split(":")[0] for l in lines] == \
        [l.split(":")[0] for l in theirs.summary().splitlines()]
    # an exception inside a stage still counts its time
    try:
        with ours.stage("fail"):
            raise ValueError
    except ValueError:
        pass
    assert ours.counts["fail"] == 1


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(str(tmp_path), "trace.json")
    with open(path) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())
