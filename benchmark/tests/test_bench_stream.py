"""The traffic: seamless laps of one motion period, the same inputs for
the same seed, the same sizes for every seed."""
from __future__ import annotations

import numpy as np
import pytest

import harness as H
import scene


@pytest.fixture(scope="module")
def streams():
    cell = H.load_cell("rpg.tick")
    return cell, {s: H.make_stream(cell, s)[1] for s in (3, 3, 2 ** 31 + 9)}


def test_trajectory_repeats_every_period():
    t = np.linspace(0.0, 1.0, 37)
    for scale in (1.0, 4.0):
        a = scene.pose_at(t, 1.0, scale)
        b = scene.pose_at(t + 3.0, 1.0, scale)
        assert np.abs(a - b).max() < 1e-9
        assert np.allclose(np.linalg.det(a[:, :3, :3]), 1.0)


def test_seam_is_continuous(streams):
    _, by_seed = streams
    for s in by_seed.values():
        res = scene.check_seam(s)
        assert res["pose_gap"] < 1e-9 and 0.5 < res["head_tail_events"] < 2


def test_laps_continue_without_a_gap(streams):
    _, by_seed = streams
    s = by_seed[3]
    t, fl, fr = s.ticks_at(s.ticks - 3, 6)
    assert np.allclose(np.diff(t), s.tick)
    for k in range(6):
        lo = t[k] - s.tick
        ev = fl["t"][k][fl["valid"][k]]
        assert ev.size and (ev > lo - 1e-4).all() and (ev <= t[k] + 1e-4).all()
    # a lap replays the first period's events, shifted by the period
    t0, a, _ = s.ticks_at(5, 1)
    t1, b, _ = s.ticks_at(5 + 2 * s.ticks, 1)
    assert t1[0] - t0[0] == pytest.approx(2 * s.period)
    assert np.array_equal(a["x"], b["x"]) and np.array_equal(a["valid"],
                                                            b["valid"])
    assert np.allclose(b["t"][b["valid"]] - a["t"][a["valid"]], 2.0,
                       atol=1e-5)
    assert np.abs(s.gt_pose(t1[0]) - s.gt_pose(t0[0])).max() < 1e-9


def test_same_seed_same_inputs_and_every_seed_same_sizes(streams):
    """The seed draws the scene and the start in the period: the same
    seed gives the same frames, another seed another scene at the same
    sizes, and the runner's capacity holds all but a sliver of every
    scene's events."""
    cell, by_seed = streams
    a, b = H.make_stream(cell, 3)[1], by_seed[3]
    c = by_seed[2 ** 31 + 9]
    assert a.start == b.start
    starts = {H.make_stream(cell, s)[1].start for s in range(5)}
    assert len(starts) > 1
    cap = cell.config["capacity"]
    assert cap == 4 * cell.config["system"]["mapping"]["process_event_num"]
    assert not np.array_equal(a.points, c.points)
    for fa, fb, fc in zip(a.frames, b.frames, c.frames):
        for k in fa:
            assert np.array_equal(fa[k], fb[k])
        assert fa["x"].shape == fc["x"].shape == (a.ticks, cap)
        for f in (fa, fc):
            events = f["valid"].sum() + f["dropped"].sum()
            assert f["dropped"].sum() < 0.01 * events
            assert 0.5 * cap < events / a.ticks < cap
