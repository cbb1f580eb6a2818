"""State carried across: the port's checkpoint (runtime/checkpoint.py)
and convert.system_state_from_numpy, which share one code path.

- port -> port: save, load into a fresh system, every saved array back
  exactly, and both systems continue identically (closed loop: the
  tracker's generator state travels with the checkpoint);
- JAX -> port: a checkpoint written by the JAX package's save_checkpoint
  loads into the port with every saved array exact; the port rebuilds
  the frame from the restored window at the fusion tolerances of
  test_torch_fusion.py;
- one tracked tick after the hand-over (in memory, no disk): the JAX
  system's _track and the port's track on the next tick's surface with
  the same selected points (JAX's _select_ref_points output handed
  over): the pose within 1e-4 m and 1e-4 rad.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.io import synthetic as jsyn
from esvo_tpu.runtime import checkpoint as jckpt
from esvo_tpu.runtime import system as jsys
from esvo_tpu.tracking.registration import RegProblemConfig as JRC
from esvo_tpu_torch import convert
from esvo_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
from esvo_tpu_torch.runtime.system import EsvoSystem, SystemStatus
from esvo_tpu_torch.tracking.registration import RegProblemConfig
from test_torch_fusion import _assert_grids
from test_torch_system import (MAP_TICKS, _frame, _mv_configs,  # noqa: F401
                               few_threads, mv_world)

TRACKER = dict(max_registration_points=400, batch_size=100)
HANDOVER_TICK = MAP_TICKS[1] + 1       # after the bootstrap and one cycle


def _configs():
    jc, tc = _mv_configs()
    jc.tracker = JRC(**TRACKER)
    tc.tracker = RegProblemConfig(**TRACKER)
    return jc, tc


def _port(rig, cfg, seed=0):
    return EsvoSystem(convert.rig_from_numpy(convert.rig_to_numpy(rig),
                                             device="cpu"), cfg, seed=seed,
                      device="cpu")


def _run(system, world, k0, k1, gt):
    rig, scene, ticks, (fl, fr) = world
    for k in range(k0, k1):
        t = float(ticks[k])
        system.process_tick(
            t, _frame(fl, k), _frame(fr, k),
            gt_pose=jsyn.interpolate_gt_pose(scene, t) if gt else None,
            do_mapping=k in MAP_TICKS)


def _assert_arrays_equal(got: dict, want: dict, skip=()):
    for key in want:
        if key in skip:
            continue
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


def test_port_checkpoint_round_trip_continues_identically(mv_world,
                                                          tmp_path):
    _, tc = _configs()
    a = _port(mv_world[0], tc, seed=3)
    _run(a, mv_world, 0, HANDOVER_TICK, gt=False)      # closed loop
    assert a.status == SystemStatus.WORKING and len(a._ref_maps) > 0
    save_checkpoint(a, str(tmp_path / "ckpt"))
    b = load_checkpoint(_port(mv_world[0], tc, seed=99),
                        str(tmp_path / "ckpt"))
    arrays_a, meta_a = convert.system_state_to_numpy(a)
    arrays_b, meta_b = convert.system_state_to_numpy(b)
    assert meta_b == meta_a
    _assert_arrays_equal(arrays_b, arrays_a)
    end = len(mv_world[2])
    _run(a, mv_world, HANDOVER_TICK, end, gt=False)
    _run(b, mv_world, HANDOVER_TICK, end, gt=False)
    assert b.status == a.status == SystemStatus.WORKING
    np.testing.assert_array_equal(b.trajectory()[1], a.trajectory()[1])
    np.testing.assert_array_equal(b.grid.inv_depth.numpy(),
                                  a.grid.inv_depth.numpy())
    assert b.stats == a.stats


@pytest.fixture(scope="module")
def jax_working(mv_world, tmp_path_factory):
    """A JAX system in MVStereo mode, WORKING after the bootstrap and one
    mapping cycle, and its checkpoint on disk."""
    jc, _ = _configs()
    js = jsys.EsvoSystem(mv_world[0], jc, seed=0)
    _run(js, mv_world, 0, HANDOVER_TICK, gt=True)
    assert js.status == jsys.SystemStatus.WORKING
    path = str(tmp_path_factory.mktemp("jax_ckpt"))
    jckpt.save_checkpoint(js, path)
    return js, path


def test_jax_checkpoint_loads_into_port(mv_world, jax_working):
    js, path = jax_working
    _, tc = _configs()
    ts = load_checkpoint(_port(mv_world[0], tc), path)
    with np.load(f"{path}/state.npz") as data:
        saved = {k: data[k] for k in data.files}
    got, meta = convert.system_state_to_numpy(ts)
    # the grid is rebuilt from the window; JAX's rng_key is not carried
    _assert_arrays_equal(got, saved,
                         skip=[k for k in saved if k.startswith("grid/")]
                         + ["rng_key"])
    assert meta == jckpt._meta(js)
    assert ts.status == SystemStatus.WORKING
    _assert_grids(ts.grid, js.grid)
    assert len(ts._ref_maps) == 1
    n = ts._ref_maps[0][2]
    assert n == int(np.asarray(js._ref_maps[-1][1]).sum()) > 100


def _angle(Ra, Rb):
    E = Ra @ Rb.T
    w = 0.5 * np.array([E[2, 1] - E[1, 2], E[0, 2] - E[2, 0],
                        E[1, 0] - E[0, 1]])
    return np.arctan2(np.linalg.norm(w), (np.trace(E) - 1) / 2)


def test_tracked_tick_after_handover(mv_world, jax_working):
    js, _ = jax_working
    _, tc = _configs()
    ts = convert.system_state_from_numpy(_port(mv_world[0], tc),
                                         jckpt._flatten(js), jckpt._meta(js))
    rig, scene, ticks, (fl, fr) = mv_world
    k = HANDOVER_TICK
    el, er = _frame(fl, k), _frame(fr, k)
    _, _, sl_j, _ = js._render_tick(
        js.ts_state_left, js.ts_state_right, js._event_batch(el),
        js._event_batch(er), jnp.asarray(ticks[k], jnp.float32))
    sl_j = sl_j.astype(js.dtype)
    ref_pts, ref_ok, _ = js._current_ref_map()
    key = jax.random.PRNGKey(5)
    pts, ok = js._select_ref_points(ref_pts, ref_ok, key)
    T_wf = jnp.asarray(js.T_world_frame, js.dtype)
    T_cur = jnp.asarray(js.T_world_cur, js.dtype)
    T_j, rms_j, nsel = js._track(sl_j, T_wf, T_cur, ref_pts, ref_ok, key)
    assert int(nsel) == int(np.asarray(ok).sum()) > 100

    _, _, sl_t, _ = ts.cycle.render_tick(
        ts.ts_state_left, ts.ts_state_right, ts._event_batch(el),
        ts._event_batch(er), float(ticks[k]))
    T_t, rms_t = ts.track(sl_t, ts._tensor(js.T_world_frame),
                          ts._tensor(js.T_world_cur),
                          torch.tensor(np.asarray(pts)),
                          torch.tensor(np.asarray(ok)))
    T_j, T_t = np.asarray(T_j, np.float64), T_t.double().numpy()
    assert np.linalg.norm(T_t[:3, 3] - T_j[:3, 3]) < 1e-4
    assert _angle(T_t[:3, :3], T_j[:3, :3]) < 1e-4
    np.testing.assert_allclose(rms_t.numpy(), np.asarray(rms_j), rtol=1e-3)
    # the tracker moved the pose: the tick is not a no-op
    assert np.linalg.norm(T_j[:3, 3] - js.T_world_cur[:3, 3]) > 1e-5


def _correction() -> np.ndarray:
    """A pose-graph-sized fold-back: 0.03 rad about a skew axis, 9 cm."""
    w = 0.03 * np.array([0.3, 1.0, 0.2]) / np.linalg.norm([0.3, 1.0, 0.2])
    th = np.linalg.norm(w)
    Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    corr = np.eye(4)
    corr[:3, :3] = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    corr[:3, 3] = [0.05, -0.03, 0.07]
    return corr


def test_world_correction_after_handover(mv_world, jax_working):
    """One world correction (what BackendLoop and PoseGraphLoop fold back)
    through both packages' apply_world_correction on the same state: every
    world-frame quantity equal within 1e-6 (float32 window poses) and the
    ref map moved by the correction; then one tracked tick on the
    corrected state, the port within 1e-4 m / rad of JAX, and in both the
    tracked pose is the correction times the uncorrected one within 1e-4:
    the fold-back changes the world frame and nothing else."""
    js, path = jax_working
    jc, tc = _configs()
    jcopy = jckpt.load_checkpoint(jsys.EsvoSystem(mv_world[0], jc, seed=0),
                                  path)
    ts = load_checkpoint(_port(mv_world[0], tc), path)
    rig, scene, ticks, (fl, fr) = mv_world
    k = HANDOVER_TICK
    el, er = _frame(fl, k), _frame(fr, k)
    _, _, sl_j, _ = jcopy._render_tick(
        jcopy.ts_state_left, jcopy.ts_state_right, jcopy._event_batch(el),
        jcopy._event_batch(er), jnp.asarray(ticks[k], jnp.float32))
    sl_j = sl_j.astype(jcopy.dtype)
    _, _, sl_t, _ = ts.cycle.render_tick(
        ts.ts_state_left, ts.ts_state_right, ts._event_batch(el),
        ts._event_batch(er), float(ticks[k]))
    key = jax.random.PRNGKey(5)

    def track_jax():
        ref_pts, ref_ok, _ = jcopy._current_ref_map()
        pts, ok = jcopy._select_ref_points(ref_pts, ref_ok, key)
        T, _, _ = jcopy._track(sl_j, jnp.asarray(jcopy.T_world_frame,
                                                 jcopy.dtype),
                               jnp.asarray(jcopy.T_world_cur, jcopy.dtype),
                               ref_pts, ref_ok, key)
        return np.asarray(T, np.float64), pts, ok

    T0, _, _ = track_jax()
    ref_before = {"jax": np.asarray(jcopy._current_ref_map()[0]),
                  "port": ts._current_ref_map()[0].numpy()}
    corr = _correction()
    jcopy.apply_world_correction(corr)
    ts.apply_world_correction(corr)

    want = jckpt._flatten(jcopy)
    got, _ = convert.system_state_to_numpy(ts)
    for name in ("pose/list", "traj/poses", "T_world_frame", "T_world_cur",
                 "hist/T_world_cam", "gmap/pts"):
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-6,
                                   err_msg=name)
    for pkg, after in (("jax", np.asarray(jcopy._current_ref_map()[0])),
                       ("port", ts._current_ref_map()[0].numpy())):
        moved = ref_before[pkg] @ corr[:3, :3].T + corr[:3, 3]
        np.testing.assert_allclose(after, moved, rtol=0, atol=1e-5,
                                   err_msg=pkg)

    T1, pts, ok = track_jax()
    T_t, _ = ts.track(sl_t, ts._tensor(jcopy.T_world_frame),
                      ts._tensor(jcopy.T_world_cur),
                      torch.tensor(np.asarray(pts)),
                      torch.tensor(np.asarray(ok)))
    T_t = T_t.double().numpy()
    for name, T, ref in (("port vs JAX", T_t, T1),
                         ("JAX vs correction x uncorrected", T1, corr @ T0)):
        assert np.linalg.norm(T[:3, 3] - ref[:3, 3]) < 1e-4, name
        assert _angle(T[:3, :3], ref[:3, :3]) < 1e-4, name
