"""The port's tracer (utils/profiling.py) and the spans and counters the
program records with it, on the CPU.

- Off (the default): ``span`` and ``device_span`` hand back one shared
  null object and nothing is recorded.
- On: nesting by ``parent`` and root ``id``, late attributes, counters
  kept whole and per root, a span closed by an exception, a span inside
  an active ``torch.profiler`` as a ``record_function`` range, the
  export (a Chrome trace and a summary in ``StageTimer``'s format), and
  ``kernel.build`` around a build (with a stand-in compiler).
- The host path (``EsvoSystem.process_tick``) on the closed-loop world of
  tests/test_torch_system.py: one ``tick`` root a tick with its children
  under it, ``mapped`` on exactly the ticks that dispatched a WORKING
  cycle, its stage and publish spans under ``tick.map``, ``cycle.eager``
  on each of them (no graph on the CPU), ``tick.eager`` on every tick,
  and ``host_reads`` on a mapping tick equal to the read sites (the
  counters' row in the finalize, 2 in the global map, 1 for tracking).
  The tick's body on static buffers (the card's, eager on the CPU):
  ``tick.stage`` / ``tick.publish`` in the place of ``tick.render`` /
  ``tick.track``, ``tick.eager`` a tick.
- ``ResidentLoop`` on the CPU (its roll runs eagerly): ``resident.run``,
  ``stage`` and its parts, ``step`` and ``sync``, ``resident.ticks``
  equal to R * K, and no ``resident.replay`` (no CUDA).
"""
import json
import os
import stat

import numpy as np
import pytest
import torch

from esvo_tpu_torch.geometry.camera import make_ideal_rig
from esvo_tpu_torch.io import synthetic as tsyn
from esvo_tpu_torch.io.events import frame_events
from esvo_tpu_torch.mapping.block_matching import BlockMatchConfig
from esvo_tpu_torch.mapping.depth_refinement import DepthProblemConfig
from esvo_tpu_torch.ops import _build
from esvo_tpu_torch.runtime.config import MappingConfig, SystemConfig
from esvo_tpu_torch.runtime.resident import ResidentLoop
from esvo_tpu_torch.runtime.system import EsvoSystem, SystemStatus
from esvo_tpu_torch.tracking.registration import RegProblemConfig
from esvo_tpu_torch.utils import profiling as prof

W, H, FX, TICK, ROLL = 240, 180, 150.0, 0.01, 5
# the bootstrap cycle on tick 4, WORKING cycles on ticks 9 and 14
N_TICKS, MAP_EVERY = 15, 5


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and empty."""
    prof.disable()
    prof.take()
    yield
    prof.disable()
    prof.take()


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """tests/test_torch_system.py's closed-loop world (a shorter run)."""
    rng = np.random.default_rng(7)
    rig = make_ideal_rig(W, H, FX, FX, W / 2 - 0.5, H / 2 - 0.5, 0.1,
                         device="cpu")
    scene = tsyn.make_scene(rng, num_points=4000, duration=0.8, steps=81,
                            motion_scale=0.6)
    ev_l, ev_r = tsyn.simulate_stereo_events(
        scene, rig.left.params.P.double().numpy(),
        rig.right.params.P.double().numpy(), W, H, pixel_threshold=0.75,
        rng=rng)
    ticks = np.arange(TICK, 0.8, TICK)[:N_TICKS + 5]
    return rig, scene, ticks, (frame_events(ev_l, ticks, 3000),
                               frame_events(ev_r, ticks, 3000))


def _config():
    """tests/test_torch_system.py's _loop_config."""
    return SystemConfig(
        depth=DepthProblemConfig(max_iteration=8),
        bm=BlockMatchConfig(zncc_threshold=0.25),
        tracker=RegProblemConfig(max_registration_points=500, batch_size=250),
        mapping=MappingConfig(process_event_num=400,
                              init_sgm_num_threshold=150,
                              std_var_vis_threshold=0.05,
                              age_vis_threshold=0, denoising=False,
                              regularization=False))


def _frames(frames, sl):
    return {k: v[sl] for k, v in frames.items() if k != "dropped"}


def _by_id(spans) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s["id"], []).append(s)
    return out


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def test_off_records_nothing():
    assert not prof.enabled()
    a, b = prof.span("tick"), prof.span("tick.render", t=1.0)
    assert a is b is prof.NULL_SPAN is prof.device_span("resident.replay")
    with prof.span("tick") as sp:
        sp.set(mapped=True)
        prof.count("host_reads", 3)
        with prof.device_span("resident.replay"):
            pass
    assert prof.take() == {"spans": [], "counters": {}}


def test_spans_nest_by_parent_and_root_id():
    prof.enable()
    with prof.span("tick", t=0.5, mapped=False) as root:
        prof.count("host_reads", 2)
        with prof.span("tick.track"):
            with prof.span("tick.track.read"):
                prof.count("host_reads")
        root.set(mapped=True)
    with prof.span("tick", t=0.6):
        pass
    prof.count("host_reads")            # outside any root: the total only
    got = prof.take()
    assert got["counters"] == {"host_reads": 4}
    names = [s["name"] for s in got["spans"]]
    assert names == ["tick.track.read", "tick.track", "tick", "tick"]
    read, track, first, second = got["spans"]
    assert (read["parent"], track["parent"], first["parent"]) == \
        ("tick.track", "tick", None)
    assert read["id"] == track["id"] == first["id"] != second["id"]
    assert first["attrs"] == {"t": 0.5, "mapped": True}
    assert first["counts"] == {"host_reads": 3}
    assert "counts" not in track and second["counts"] == {}
    assert first["start_ns"] <= track["start_ns"] <= read["start_ns"] \
        <= read["end_ns"] <= track["end_ns"] <= first["end_ns"]
    # device spans record nothing without CUDA
    with prof.device_span("resident.replay"):
        pass
    assert prof.take() == {"spans": [], "counters": {}}


def test_span_closes_on_exception():
    prof.enable()
    with pytest.raises(ValueError):
        with prof.span("resident.run"):
            with prof.span("resident.stage"):
                raise ValueError("inside")
    with prof.span("resident.sync"):
        pass
    spans = prof.take()["spans"]
    assert [s["name"] for s in spans] == ["resident.stage", "resident.run",
                                          "resident.sync"]
    assert spans[2]["parent"] is None and spans[2]["id"] != spans[1]["id"]


def test_span_is_a_record_function_inside_a_profiler():
    def profiled():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as p:
            with prof.span("tick.render"):
                torch.ones(8) + 1
        return [e.name for e in p.events()]

    assert "tick.render" not in profiled()
    prof.enable()
    assert "tick.render" in profiled()
    assert [s["name"] for s in prof.take()["spans"]] == ["tick.render"]


def test_stage_timer_records_through_the_tracer():
    timer = prof.StageTimer()
    with timer.stage("render"):
        pass
    assert prof.take()["spans"] == []
    prof.enable()
    with timer.stage("render"):
        pass
    spans = prof.take()["spans"]
    assert [s["name"] for s in spans] == ["render"]
    assert timer.counts["render"] == 2
    assert timer.totals["render"] >= \
        (spans[0]["end_ns"] - spans[0]["start_ns"]) * 1e-9


def test_export_writes_a_chrome_trace_and_a_summary(tmp_path):
    prof.enable()
    for t in (0.1, 0.2):
        with prof.span("tick", t=t, mapped=t > 0.15):
            prof.count("host_reads")
            with prof.span("tick.render"):
                pass
    records = prof.take()
    records["spans"].append(dict(name="resident.replay", parent=None,
                                 id=None, device_ms=1.5))
    summary = prof.export(records, str(tmp_path / "trace"))
    with open(tmp_path / "trace" / "spans.json") as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    assert [e["name"] for e in events] == ["tick", "tick.render"] * 2
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert events[2]["args"]["mapped"] is True
    assert events[0]["args"]["counts"] == {"host_reads": 1}
    assert trace["otherData"]["counters"] == {"host_reads": 2}
    lines = summary.splitlines()
    assert {l.split(":")[0].strip() for l in lines} == {
        "tick", "tick.render", "resident.replay (device)", "host_reads"}
    assert any("x2" in l and l.strip().startswith("tick:") for l in lines)
    assert (tmp_path / "trace" / "summary.txt").read_text().strip() == \
        summary


def test_kernel_build_span(tmp_path, monkeypatch):
    """A build records ``kernel.build`` (with its sources) and counts
    ``kernel.builds``; a library already built records nothing. The
    compiler is a stand-in that writes its -o file."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    prof.enable()
    paths = _build.build(["remap.cu", "lm.cu"])
    assert all(os.path.exists(p) for p in paths.values())
    got = prof.take()
    assert [s["name"] for s in got["spans"]] == ["kernel.build"]
    assert got["spans"][0]["attrs"] == {"sources": ["remap.cu", "lm.cu"]}
    assert got["counters"] == {"kernel.builds": 2}
    _build.build(["remap.cu"])
    assert prof.take() == {"spans": [], "counters": {}}


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------

def test_process_tick_spans(world):
    rig, scene, ticks, (fl, fr) = world
    system = EsvoSystem(rig, _config(), device="cpu", seed=3)
    prof.enable()
    for k in range(N_TICKS):
        gt = (tsyn.interpolate_gt_pose(scene, float(ticks[k]))
              if k == N_TICKS - 1 else None)
        system.process_tick(float(ticks[k]), _frames(fl, k), _frames(fr, k),
                            gt_pose=gt, do_mapping=k % MAP_EVERY == 4)
        if k == 4:
            assert system.status == SystemStatus.WORKING
    got = prof.take()
    spans = got["spans"]
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["tick"] * N_TICKS
    assert [s["attrs"]["t"] for s in roots] == [float(t)
                                                for t in ticks[:N_TICKS]]
    # mapped: the WORKING cycles of ticks 9 and 14 (4 bootstraps)
    assert [k for k, s in enumerate(roots) if s["attrs"]["mapped"]] == \
        [9, 14]
    groups = _by_id(spans)
    assert len(groups) == N_TICKS
    parents = {"tick.render": "tick", "tick.track": "tick",
               "tick.track.read": "tick.track", "tick.map": "tick",
               "tick.map.stage": "tick.map", "tick.map.publish": "tick.map",
               "tick.finalize": "tick", "tick.global_map": "tick.finalize",
               "tick.bootstrap": "tick"}
    for k, root in enumerate(roots):
        kids = [s for s in groups[root["id"]] if s is not root]
        assert all(parents[s["name"]] == s["parent"] for s in kids)
        assert all(root["start_ns"] <= s["start_ns"] <= s["end_ns"]
                   <= root["end_ns"] for s in kids)
        names = sorted(s["name"] for s in kids)
        tracked = 5 <= k < N_TICKS - 1
        want = ["tick.render"] + (["tick.track", "tick.track.read"]
                                  if tracked else [])
        if k == 4:
            want += ["tick.bootstrap"]
        if root["attrs"]["mapped"]:
            want += ["tick.finalize", "tick.global_map", "tick.map",
                     "tick.map.stage", "tick.map.publish"]
        assert names == sorted(want), (k, names)
        # the read sites: 1 for tracking; on a mapping tick 1 in the
        # finalize (the cycle's counters in one row) and 2 in the global
        # map; the bootstrap's 2
        reads = (int(tracked) + 3 * root["attrs"]["mapped"]
                 + 2 * (k == 4))
        assert root["counts"].get("host_reads", 0) == reads, k
        # the CPU runs the cycle's body eagerly: no graph, no replay
        assert root["counts"].get("cycle.eager", 0) == \
            root["attrs"]["mapped"], k
        # and the tick's body: one eager tick each
        assert root["counts"]["tick.eager"] == 1, k
    assert roots[9]["counts"]["host_reads"] == 4
    assert roots[14]["counts"]["host_reads"] == 3
    assert got["counters"]["host_reads"] == sum(
        r["counts"].get("host_reads", 0) for r in roots)
    assert got["counters"]["cycle.eager"] == 2
    assert got["counters"]["tick.eager"] == N_TICKS
    assert not {"cycle.replays", "tick.replays", "graph.captures"} & set(
        got["counters"])


def test_static_tick_spans(world):
    """The tick's body on static buffers (the card's, run eagerly on the
    CPU): ``tick.stage`` and ``tick.publish`` under ``tick`` in the place
    of ``tick.render`` / ``tick.track``, ``tick.track.read`` under
    ``tick`` on a tracked tick, ``tick.eager`` once a tick and no replay,
    capture or device span."""
    rig, scene, ticks, (fl, fr) = world
    system = EsvoSystem(rig, _config(), device="cpu", seed=3)
    system._tick_plain = system._tick_static
    prof.enable()
    for k in range(10):
        system.process_tick(float(ticks[k]), _frames(fl, k), _frames(fr, k),
                            do_mapping=k % MAP_EVERY == 4)
    got = prof.take()
    spans = got["spans"]
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["tick"] * 10
    groups = _by_id(spans)
    for k, root in enumerate(roots):
        kids = sorted(s["name"] for s in groups[root["id"]]
                      if s["parent"] == "tick")
        want = ["tick.publish", "tick.stage"] + (["tick.track.read"]
                                                 if k >= 5 else [])
        want += {4: ["tick.bootstrap"], 9: ["tick.finalize", "tick.map"]
                 }.get(k, [])
        assert kids == sorted(want), (k, kids)
        assert root["counts"]["tick.eager"] == 1, k
        assert root["counts"].get("host_reads", 0) == (
            int(k >= 5) + 3 * (k == 9) + 2 * (k == 4)), k
    assert not any("device_ms" in s for s in spans)
    assert not {"tick.render", "tick.track", "tick.capture"} & {
        s["name"] for s in spans}
    assert got["counters"]["tick.eager"] == 10
    assert not {"tick.replays", "graph.captures"} & set(got["counters"])


def test_resident_loop_spans(world):
    rig, scene, ticks, (fl, fr) = world
    system = EsvoSystem(rig, _config(), device="cpu", seed=3)
    sl = slice(0, ROLL)
    system.process_ticks(ticks[sl], _frames(fl, sl), _frames(fr, sl),
                         do_mapping=True)
    assert system.status == SystemStatus.WORKING
    R = 2
    loop = ResidentLoop(system, ticks_per_roll=ROLL, rolls_per_dispatch=R)
    loop.start()
    prof.enable()
    sl = slice(ROLL, ROLL + R * ROLL)
    loop.run(ticks[sl], _frames(fl, sl), _frames(fr, sl))
    loop.sync()
    got = prof.take()
    spans = got["spans"]
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["resident.run", "resident.sync"]
    run, sync = roots
    under = lambda root: sorted(s["name"] for s in spans
                                if s["id"] == root["id"] and s is not root)
    stage = ["resident.stage", "resident.stage.arrays",
             "resident.stage.copy", "resident.stage.scores"]
    assert under(run) == sorted(stage * R + ["resident.step"] * R
                                + ["resident.render"])
    assert under(sync) == ["resident.sync.read"]
    assert all(s["parent"] == "resident.stage" for s in spans
               if s["name"].startswith("resident.stage."))
    assert not any("device_ms" in s for s in spans)
    assert got["counters"]["resident.ticks"] == R * ROLL
    assert "resident.replays" not in got["counters"]
    assert run["counts"] == {"resident.ticks": R * ROLL}
    # the ring, rolls_since_good, num_rejects and the two poses
    assert sync["counts"] == {"host_reads": 5}
    loop.finish()
