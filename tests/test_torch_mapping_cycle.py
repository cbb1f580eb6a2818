"""The slice as a whole: the port's MappingCycle against the JAX package's
EsvoSystem programs (_render_tick, _map_estimate, _rebuild_frame) over two
WORKING mapping cycles of a synthetic scene, on the very same rig, events
and pose table.

- surfaces: within one 8-bit level everywhere, equal to 1e-4 on at least
  99.9% of the pixels;
- estimates: validity agreement > 98%; on the events valid in both, the
  inverse depth at the LM tolerances of test_torch_lm.py. The JAX side
  runs its depth solve through the Pallas kernel in interpret mode
  (lm_kernel="pallas"), the path the port's kernel and twin follow: its
  XLA scan reaches other local minima on a few events of these sparse
  synthetic surfaces (up to 5e-3 apart from the Pallas kernel here);
- fused grid: the port's rebuild_frame on the JAX history (handed over by
  convert.state_from_numpy) against JAX's, at the fusion tolerances of
  test_torch_fusion.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.geometry import camera as jcam
from esvo_tpu.io import synthetic as jsyn
from esvo_tpu.io.events import frame_events as jframe_events
from esvo_tpu.mapping.block_matching import BlockMatchConfig as JBM
from esvo_tpu.mapping.depth_refinement import DepthProblemConfig as JDP
from esvo_tpu.runtime import system as jsys
from esvo_tpu.runtime.config import MappingConfig as JMC, SystemConfig
from esvo_tpu.surface import time_surface as jts
from esvo_tpu_torch import convert
from esvo_tpu_torch.io import synthetic as tsyn
from esvo_tpu_torch.io.events import frame_events
from esvo_tpu_torch.mapping.block_matching import BlockMatchConfig
from esvo_tpu_torch.mapping.depth_refinement import DepthProblemConfig
from esvo_tpu_torch.runtime.config import (MappingConfig,
                                           SystemConfig as TSystemConfig)
from esvo_tpu_torch.runtime.system import MappingCycle
from esvo_tpu_torch.surface import time_surface as tts
from test_torch_fusion import _assert_grids
from test_torch_lm import assert_inv_depth_agree

W, H, FX, BASELINE = 120, 90, 75.0, 0.1
# the rectified principal point sits off the raw one by a fraction of a
# pixel, so rectified event coordinates are not integers: on an ideal rig
# they are, the LM starts on the kinks of the bilinear surfaces, and the
# kernel and the twin then race at float32 rounding into other minima
OFFSET = (0.37, 0.21)
N, TICK, CAP = 256, 0.01, 1500
MAP_TICKS = (4, 9)          # two mapping cycles


def _configs():
    mapping = dict(process_event_num=N, max_fusion_points=300,
                   std_var_vis_threshold=0.05, age_vis_threshold=0)
    depth = dict(max_iteration=8, regularization_radius=2,
                 regularization_min_neighbours=2,
                 regularization_min_close_neighbours=1)
    jc = SystemConfig(depth=JDP(lm_kernel="pallas", **depth),
                      bm=JBM(zncc_threshold=0.25),
                      mapping=JMC(**mapping))
    tc = TSystemConfig(depth=DepthProblemConfig(**depth),
                       bm=BlockMatchConfig(zncc_threshold=0.25),
                       mapping=MappingConfig(**mapping))
    return jc, tc


def _rig():
    cx, cy = W / 2 - 0.5, H / 2 - 0.5
    K = np.array([[FX, 0, cx], [0, FX, cy], [0, 0, 1]])
    cams, raw = [], []
    for tx in (0.0, -FX * BASELINE):
        P = np.array([[FX, 0, cx + OFFSET[0], tx], [0, FX, cy + OFFSET[1], 0],
                      [0, 0, 1, 0]])
        f = jnp.float32
        cams.append(jcam.make_camera(jcam.PinholeParams(
            K=jnp.asarray(K, f), D=jnp.zeros(4, f), R=jnp.eye(3, dtype=f),
            P=jnp.asarray(P, f), width=W, height=H)))
        raw.append(np.concatenate([K, [[tx], [0], [0]]], axis=1))
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -BASELINE
    rig = jcam.StereoRig(left=cams[0], right=cams[1],
                         T_right_left=jnp.asarray(T),
                         baseline=jnp.asarray(BASELINE, jnp.float32))
    return rig, raw


@pytest.fixture(scope="module")
def world():
    rig, (P_l, P_r) = _rig()      # events are made at raw pixels
    streams = []
    for syn in (tsyn, jsyn):
        rng = np.random.default_rng(11)
        scene = syn.make_scene(rng, num_points=2000, duration=0.15,
                               steps=16, motion_scale=0.6)
        streams.append((scene, *syn.simulate_stereo_events(
            scene, P_l, P_r, W, H, pixel_threshold=0.75, rng=rng)))
    (scene, ev_l, ev_r), (_, jev_l, _) = streams
    # the port's numpy copy of the simulator makes the same events
    np.testing.assert_array_equal(ev_l.t, jev_l.t)
    np.testing.assert_array_equal(ev_l.x, jev_l.x)
    ticks = np.arange(1, 11) * TICK
    frames = (frame_events(ev_l, ticks, CAP), frame_events(ev_r, ticks, CAP))
    for a, b in zip(frames[0].values(), jframe_events(jev_l, ticks,
                                                      CAP).values()):
        np.testing.assert_array_equal(a, b)
    return rig, scene, ticks, frames


def _frame(frames, k):
    return [frames[key][k] for key in ("x", "y", "t", "p", "valid")]


def test_two_cycles_match_jax(world):
    rig, scene, ticks, (fl, fr) = world
    jc, tc = _configs()
    system = jsys.EsvoSystem(rig, jc)
    cycle = MappingCycle(convert.rig_from_numpy(convert.rig_to_numpy(rig),
                                                device="cpu"), tc,
                         device="cpu")
    assert cycle.F == system.F == 2 and cycle.N == system.N == N
    f32 = np.float32
    pose_t = scene.traj_times.astype(f32)
    pose_T = scene.traj_poses.astype(f32)

    sl_j, sr_j = jts.init_state(H, W), jts.init_state(H, W)
    sl_t, sr_t = (tts.init_state(H, W, device="cpu") for _ in range(2))
    history_j = system.history
    slot = 0
    n_cycles = 0
    for k, t in enumerate(ticks):
        el, er = _frame(fl, k), _frame(fr, k)
        sl_j, sr_j, ts_lj, ts_rj = system._render_tick(
            sl_j, sr_j, jts.EventBatch.from_arrays(*el),
            jts.EventBatch.from_arrays(*er), jnp.float32(t))
        sl_t, sr_t, ts_lt, ts_rt = cycle.render_tick(
            sl_t, sr_t, tts.EventBatch.from_arrays(*el, device="cpu"),
            tts.EventBatch.from_arrays(*er, device="cpu"), float(t))
        for a, b in ((ts_lt, ts_lj), (ts_rt, ts_rj)):
            diff = np.abs(a.numpy() - np.asarray(b))
            assert diff.max() <= 1.0 + 1e-4
            assert (diff <= 1e-4).mean() >= 0.999
        if k not in MAP_TICKS:
            continue
        T_wf = jsyn.interpolate_gt_pose(scene, float(t)).astype(f32)
        ev = [fl[key][k] for key in ("x", "y", "t", "valid")]
        est_j, nv_j, bm_j = system._map_estimate(
            ts_lj, ts_rj, *[jnp.asarray(a) for a in ev],
            jnp.asarray(pose_t), jnp.asarray(pose_T), jnp.asarray(T_wf))
        est_t, nv_t, bm_t = cycle.mapping_estimate(
            ts_lt, ts_rt, *[torch.from_numpy(a) for a in ev],
            torch.from_numpy(pose_t), torch.from_numpy(pose_T),
            torch.from_numpy(T_wf))
        va, vb = np.asarray(est_j.valid), est_t.valid.numpy()
        assert va.sum() > 0.2 * N
        assert (va == vb).mean() > 0.98
        both = va & vb
        assert_inv_depth_agree(est_t.inv_depth.numpy()[both],
                               np.asarray(est_j.inv_depth)[both])
        matched = {n: int(v) for n, v in bm_t.items()}
        assert matched["input"] == int(bm_j["input"])
        assert abs(matched["matched"] - int(bm_j["matched"])) <= 0.02 * N

        history_j = jsys._tree_stack_slot(history_j, est_j, slot)
        slot = (slot + 1) % system.F
        cycle.push_history(est_t)
        grid_j, pts_j, occ_j, nf_j, nd_j = system._rebuild_frame(
            history_j, jnp.asarray(T_wf))
        hist = convert.state_from_numpy(
            {"history": convert.fields_to_numpy(history_j)},
            device="cpu")["history"]
        grid_t, pts_t, occ_t, nf_t, nd_t = cycle.rebuild_frame(
            hist, torch.from_numpy(T_wf))
        assert int(nf_t) == int(nf_j) and int(nd_t) == int(nd_j)
        _assert_grids(grid_t, grid_j)
        # the port's own window holds the same frames to the LM tolerance
        own = cycle.rebuild_frame(cycle.history, torch.from_numpy(T_wf))[2]
        assert (own.numpy() == np.asarray(occ_j)).mean() > 0.98
        n_cycles += 1
    assert n_cycles == len(MAP_TICKS)


def test_cycle_pieces_and_state_converter(world):
    """denoise -> compact -> LUT lookup against the JAX system's own
    pieces on one tick's events (all exact), the history size rule of
    both fusion strategies, and a time-surface state and a depth grid
    handed over by convert.state_from_numpy unchanged."""
    from esvo_tpu.mapping import fusion as jfu
    from esvo_tpu.mapping import initialization as jinit
    from esvo_tpu_torch.mapping import initialization as tinit

    rig, scene, ticks, (fl, fr) = world
    jc, tc = _configs()
    system = jsys.EsvoSystem(rig, jc)
    cycle = MappingCycle(convert.rig_from_numpy(convert.rig_to_numpy(rig),
                                                device="cpu"), tc,
                         device="cpu")
    k = 6
    x, y, t, valid = (fl[key][k] for key in ("x", "y", "t", "valid"))
    mask_j = jinit.denoising_mask(jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(valid), H, W)
    mask_t = tinit.denoising_mask(torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(valid), H, W)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    sel_j = jinit.select_denoised(jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(valid), mask_j, 100)
    sel_t = tinit.select_denoised(torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(valid), mask_t, 100)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    assert 0 < sel_t.sum() <= 100
    out_j = system._compact(sel_j, jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(t))
    out_t = cycle.compact(sel_t, *(torch.from_numpy(a) for a in (x, y, t)))
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        cycle.lut_lookup(out_t[2], out_t[1]).numpy(),
        np.asarray(jsys._lut_lookup(rig.left.lut, out_j[2], out_j[1], H, W)))

    for strategy in ("CONST_POINTS", "CONST_FRAMES"):
        m = dict(process_event_num=700, max_fusion_points=5000,
                 max_fusion_frames=6, fusion_strategy=strategy)
        assert TSystemConfig(mapping=MappingConfig(**m)).history_frames \
            == jsys.EsvoSystem(rig, SystemConfig(mapping=JMC(**m))).F

    st_j = jts.insert_events(jts.init_state(H, W),
                             jts.EventBatch.from_arrays(*_frame(fl, k)))
    grid_j = jfu.empty_grid(H, W)
    state = convert.state_from_numpy(
        {"ts_left": convert.fields_to_numpy(st_j),
         "grid": convert.fields_to_numpy(grid_j)}, device="cpu")
    for key, obj in (("ts_left", st_j), ("grid", grid_j)):
        for name, arr in convert.fields_to_numpy(obj).items():
            np.testing.assert_array_equal(
                getattr(state[key], name).numpy(), arr, err_msg=name)
    with pytest.raises(KeyError):
        convert.state_from_numpy({"grid": {"inv_depth": np.zeros((H, W))}})
