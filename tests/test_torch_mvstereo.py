"""The port's MVStereoSystem (runtime/mvstereo.py) against the JAX
package's on tests/test_mvstereo.py's world cut to 15 ticks with a mapping
cycle at ticks 4, 9 and 14, in float32: the block-matching and SGM modes
(1, 4) here, mode 3 in tests/test_torch_mvstereo_bm_lm.py and the
event-matching modes (0, 2) in tests/test_torch_mvstereo_em.py. The one
change to that world: the rectified principal point sits off the raw one
by a fraction of a pixel (as in tests/test_torch_mapping_cycle.py), so
rectified event coordinates are not integers. On the ideal rig they are, and a one-ulp difference then
moves a point across a pixel border in the fusion or a patch across the
image border in the matcher.

At every tick the status is equal. At every mapping tick:
- the port's frame program (naive fusion, or mode 2's and mode 3's
  WORKING rebuild) on JAX's window gives JAX's frame at the fusion
  tolerances of tests/test_torch_fusion.py, except that each point's
  p_cam is held within 1e-5 of its norm (a component near zero is the
  difference of two terms of the norm's size, and rounds at that scale);
- the system's own frame: map points within max(2%, 5); the cells
  occupied in both >= 98% of the larger count; where both are occupied,
  the inverse depth within 1e-4 relative on >= 99.9% of the cells and
  2e-4 on all (modes 0 and 1; a one-ulp difference in a propagated
  point may hand a cell to another of its candidates) or at the LM
  tolerance of tests/test_torch_mapping_cycle.py (modes 2 and 3, whose
  depth LM runs on the JAX side through its Pallas kernel in interpret
  mode, the path the port's kernel and twin follow);
- frames made by the SGM bootstrap's naive fusion (every mode 4 cycle,
  mode 3's first) hold SGM points on integer pixels, on the fusion's cell
  borders, where a one-ulp difference in the window moves a point's
  splat: there the own frames' cells agree on > 99% of the image, as in
  tests/test_torch_system.py, and the program check above holds on
  >= 99.9% of the cells occupied in both (a point of an earlier SGM
  frame may still land on a border: 1 of 3183 cells in mode 4's last
  frame).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.geometry import camera as jcam
from esvo_tpu.io.events import frame_events
from esvo_tpu.io.synthetic import (interpolate_gt_pose, make_scene,
                                   simulate_stereo_events)
from esvo_tpu.mapping.event_matcher import EventMatcherConfig as JEM
from esvo_tpu.runtime import mvstereo as jmv
from esvo_tpu_torch import convert
from esvo_tpu_torch.mapping.event_matcher import EventMatcherConfig
from esvo_tpu_torch.runtime import mvstereo as tmv
from esvo_tpu_torch.runtime.config import SystemConfig
from test_system import frame_at, make_config
from test_torch_lm import assert_inv_depth_agree

W, H = 240, 180
FX = 150.0
BASELINE = 0.1
TICK = 0.01
OFFSET = (0.37, 0.21)
N_TICKS = 15
MAP_TICKS = (4, 9, 14)
EM = dict(time_threshold=2e-3, epipolar_threshold=1.0, ts_ncc_threshold=0.4,
          patch_size_x=15, patch_size_y=15, max_candidates=32)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def offset_rig():
    """The ideal rig with its rectified principal point moved by
    OFFSET px, and the raw projections the events are simulated with."""
    cx, cy = W / 2 - 0.5, H / 2 - 0.5
    K = np.array([[FX, 0, cx], [0, FX, cy], [0, 0, 1]])
    cams, raw = [], []
    for tx in (0.0, -FX * BASELINE):
        P = np.array([[FX, 0, cx + OFFSET[0], tx],
                      [0, FX, cy + OFFSET[1], 0], [0, 0, 1, 0]])
        f = jnp.float32
        cams.append(jcam.make_camera(jcam.PinholeParams(
            K=jnp.asarray(K, f), D=jnp.zeros(4, f), R=jnp.eye(3, dtype=f),
            P=jnp.asarray(P, f), width=W, height=H)))
        raw.append(np.concatenate([K, [[tx], [0], [0]]], axis=1))
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -BASELINE
    return jcam.StereoRig(left=cams[0], right=cams[1],
                          T_right_left=jnp.asarray(T),
                          baseline=jnp.asarray(BASELINE, jnp.float32)), raw


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(11)
    rig, raw_P = offset_rig()
    scene = make_scene(rng, num_points=4000, duration=0.5, steps=51,
                       motion_scale=0.6)
    ev_l, ev_r = simulate_stereo_events(scene, *raw_P, W, H,
                                        pixel_threshold=0.75, rng=rng)
    ticks = np.arange(1, N_TICKS + 1) * TICK
    return (rig, scene, ticks, frame_events(ev_l, ticks, 3000),
            frame_events(ev_r, ticks, 3000))


def configs():
    """tests/test_system.py's make_config for both packages (the JAX
    depth solve through its Pallas kernel)."""
    jc = make_config()
    jc = dataclasses.replace(
        jc, depth=dataclasses.replace(jc.depth, lm_kernel="pallas"))
    tc = SystemConfig.from_dict({
        sec: {f.name: getattr(getattr(jc, sec), f.name)
              for f in dataclasses.fields(getattr(jc, sec))
              if f.name != "lm_kernel"}
        for sec in ("depth", "bm", "sgm", "mapping")})
    return jc, tc


def run_pair(world, mode):
    """Both systems over the world's ticks; checks the status every tick
    and each mapping tick's frames (module docstring). Returns the port's
    system and the map points of its last frame."""
    rig, scene, ticks, fl, fr = world
    jc, tc = configs()
    em = mode in (0, 2)
    js = jmv.MVStereoSystem(rig, mode, jc, em_config=JEM(**EM) if em
                            else None)
    ts = tmv.MVStereoSystem(
        convert.rig_from_numpy(convert.rig_to_numpy(rig), device="cpu"),
        mode, tc, em_config=EventMatcherConfig(**EM) if em else None,
        device="cpu")
    n_cycles = 0
    for k, t in enumerate(ticks):
        gt = interpolate_gt_pose(scene, float(t))
        args = (float(t), frame_at(fl, k), frame_at(fr, k))
        do_map = k in MAP_TICKS
        oj = js.process_tick(*args, gt_pose=gt, do_mapping=do_map)
        ot = ts.process_tick(*args, gt_pose=gt, do_mapping=do_map)
        assert ot["status"] == oj["status"]
        assert ts.status.value == js.status.value
        if not do_map:
            continue
        sgm_frame = "sgm_points" in ot
        assert sgm_frame == ("sgm_points" in oj)
        hist = convert.state_from_numpy(
            {"history": convert.fields_to_numpy(js.history)},
            device="cpu")["history"]
        T_wf = ts._tensor(js.T_world_frame)
        program = (ts.cycle.seed_frame if mode in (0, 1, 4) or sgm_frame
                   else ts.cycle.rebuild_frame)
        assert_frames(program(hist, T_wf)[0], js.grid,
                      0.999 if sgm_frame else 1.0)
        check_own_frames(mode, sgm_frame, ot["map_points"],
                         oj["map_points"], *ts.depth_map(),
                         *(np.asarray(a) for a in js.depth_map()))
        n_cycles += 1
    assert n_cycles == len(MAP_TICKS)
    np.testing.assert_array_equal(ts.trajectory()[1], js.trajectory()[1])
    return ts, ot["map_points"]


def assert_frames(gt, gj, min_share=1.0):
    """Two frames at the fusion tolerances on the cells occupied in both,
    on all of them or on `min_share` of them."""
    occ_t, occ_j = gt.occupied.numpy(), np.asarray(gj.occupied)
    assert (occ_t == occ_j).mean() >= 0.999
    both = occ_t & occ_j
    assert both.sum() > 50
    close = np.ones(int(both.sum()), bool)
    for name in ("inv_depth", "variance", "scale2", "nu", "residual",
                 "age", "x"):
        a = getattr(gt, name).numpy()[both]
        b = np.asarray(getattr(gj, name))[both]
        ok = np.isclose(a, b, rtol=1e-5, atol=1e-7)
        close &= ok.reshape(len(close), -1).all(axis=1)
    p_t, p_j = gt.p_cam.numpy()[both], np.asarray(gj.p_cam)[both]
    close &= (np.abs(p_t - p_j) <= 1e-5 * np.linalg.norm(
        p_j, axis=-1, keepdims=True)).all(axis=1)
    assert close.mean() >= min_share, f"{(~close).sum()} cells apart"


def check_own_frames(mode, sgm_frame, n_t, n_j, inv_t, occ_t, inv_j, occ_j):
    assert n_t == int(occ_t.sum()) and n_j == int(occ_j.sum())
    assert abs(n_t - n_j) <= max(0.02 * n_j, 5), (n_t, n_j)
    if sgm_frame:
        assert (occ_t == occ_j).mean() > 0.99
        return
    both = occ_t & occ_j
    assert both.sum() >= 0.98 * max(n_t, n_j)
    if mode in (tmv.MVStereoMode.EM_PLUS_ESTIMATION,
                tmv.MVStereoMode.BM_PLUS_ESTIMATION):
        assert_inv_depth_agree(inv_t[both], inv_j[both])
    else:
        rel = np.abs(inv_t[both] - inv_j[both]) / np.abs(inv_j[both])
        assert (rel <= 1e-4).mean() >= 0.999 and rel.max() <= 2e-4, rel.max()


@pytest.mark.parametrize("mode", [tmv.MVStereoMode.PURE_BLOCK_MATCHING,
                                  tmv.MVStereoMode.PURE_SGM],
                         ids=lambda m: m.name.lower())
def test_mode_matches_jax(world, mode):
    _, n_points = run_pair(world, mode)
    assert n_points > 50


def test_reconfigure_rebuilds_mode_stages(world):
    """After reconfigure with another event budget, an EM mapping tick
    runs at the new width (the window and the matches take N)."""
    rig, scene, ticks, fl, fr = world
    _, tc = configs()
    ts = tmv.MVStereoSystem(
        convert.rig_from_numpy(convert.rig_to_numpy(rig), device="cpu"),
        tmv.MVStereoMode.PURE_EVENT_MATCHING, tc,
        em_config=EventMatcherConfig(**EM), device="cpu")
    assert ts.history.valid.shape[1] == 800
    ts.reconfigure(dataclasses.replace(
        tc, mapping=dataclasses.replace(tc.mapping, process_event_num=300)))
    assert ts.N == 300 and ts.history.valid.shape[1] == 300
    for k in range(5):
        t = float(ticks[k])
        out = ts.process_tick(t, frame_at(fl, k), frame_at(fr, k),
                              gt_pose=interpolate_gt_pose(scene, t),
                              do_mapping=k == 4)
    assert 0 < out["map_estimates"] <= 300
    assert out["map_points"] > 0
    with pytest.raises(ValueError, match="known poses"):
        ts.process_tick(float(ticks[5]), frame_at(fl, 5), frame_at(fr, 5))


def test_checkpoint_carries_the_mode(world, tmp_path):
    """An MVStereoSystem checkpoint (runtime/checkpoint.py) holds the
    mapping method: a system built in another mode takes it back, and
    its next mapping cycle equals the uninterrupted system's."""
    from esvo_tpu_torch.runtime.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
    rig, scene, ticks, fl, fr = world
    _, tc = configs()
    trig = convert.rig_from_numpy(convert.rig_to_numpy(rig), device="cpu")
    make = lambda mode: tmv.MVStereoSystem(trig, mode, tc, device="cpu")
    a = make(tmv.MVStereoMode.PURE_BLOCK_MATCHING)

    def tick(system, k):
        t = float(ticks[k])
        return system.process_tick(t, frame_at(fl, k), frame_at(fr, k),
                                   gt_pose=interpolate_gt_pose(scene, t),
                                   do_mapping=k % 5 == 4)

    for k in range(5):
        tick(a, k)
    save_checkpoint(a, str(tmp_path))
    b = load_checkpoint(make(tmv.MVStereoMode.PURE_SGM), str(tmp_path))
    assert b.mode == tmv.MVStereoMode.PURE_BLOCK_MATCHING
    for k in range(5, 10):
        out_a, out_b = tick(a, k), tick(b, k)
    assert out_b["map_points"] == out_a["map_points"] > 50
    np.testing.assert_array_equal(b.depth_map()[0], a.depth_map()[0])
