"""The port's device-resident closed loop (runtime/resident.py) and its
event loader (io/stream.py), on the CPU, where the resident roll runs
eagerly (on the card it is a replayed CUDA graph, tests/test_torch_cuda.py).

(a) ``_guard_append`` against the JAX package's on crafted cases: accept
    flags and counters equal, poses and pose table within 1e-6.
(b) ``_correct_body`` against the JAX package's on a seeded state, within
    1e-6.
(c) ``ResidentLoop`` against the port's own ``process_ticks``: the loop
    world of tests/test_torch_system.py, the same generator seed, rolls of
    5 ticks, 2 a dispatch, the host path mapping on every roll
    (tests/test_resident.py's drive): per-tick poses within 1e-5 m and
    1e-5 rad, map points equal, every pose accepted, rolls_since_good 0.
    (Both paths run the same ops on the same values, so today they agree
    bit for bit.)
(d) The slice against JAX: the port's ResidentLoop and the JAX package's
    on the same events and an ideal rig of the same parameters, 20
    resident ticks after the bootstrap: both WORKING, each ATE under
    tests/test_resident.py's bars (below 0.06 m; the port's below
    max(2 x JAX's, 0.06)), each package's map points above half the
    other's. The world is the loop world's 240x180: at 120x90 neither
    package's tracker holds this scene (the port's ATE 0.11-0.13 m).
(e) tests/test_resident.py's hand-off, world-correction mirror and
    watchdog, for the port.
(f) EventFrameStream against the JAX package's, frame by frame and roll by
    roll, and tests/test_stream.py's prefetch, error and memory cases.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvo_tpu.eval.trajectory import ate_rmse as jate_rmse
from esvo_tpu.geometry import camera as jcam
from esvo_tpu.io import events as jev
from esvo_tpu.io import stream as jstream
from esvo_tpu.mapping import depth_refinement as jdr
from esvo_tpu.mapping.block_matching import BlockMatchConfig as JBM
from esvo_tpu.mapping.depth_refinement import DepthProblemConfig as JDP
from esvo_tpu.runtime import resident as jres
from esvo_tpu.runtime import system as jsys
from esvo_tpu.runtime.config import MappingConfig as JMC
from esvo_tpu.runtime.config import SystemConfig as JSC
from esvo_tpu.tracking.registration import RegProblemConfig as JReg
from esvo_tpu_torch._device import constant
from esvo_tpu_torch.eval.trajectory import ate_rmse
from esvo_tpu_torch.geometry.camera import make_ideal_rig
from esvo_tpu_torch.geometry.se3 import se3_exp
from esvo_tpu_torch.io import events as tev
from esvo_tpu_torch.io import synthetic as tsyn
from esvo_tpu_torch.io.stream import EventFrameStream
from esvo_tpu_torch.mapping import depth_refinement as tdr
from esvo_tpu_torch.runtime import resident as tres
from esvo_tpu_torch.runtime.config import TrackingNodeConfig
from esvo_tpu_torch.runtime.system import EsvoSystem, SystemStatus
from test_torch_system import _loop_config

W, H, FX, TICK, ROLL = 240, 180, 150.0, 0.01, 5
N_TICKS = 45          # the bootstrap roll, then 40 resident ticks


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads, as tests/test_torch_system.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """tests/test_system.py's world, made by the port's simulator."""
    rng = np.random.default_rng(7)
    rig = make_ideal_rig(W, H, FX, FX, W / 2 - 0.5, H / 2 - 0.5, 0.1,
                         device="cpu")
    scene = tsyn.make_scene(rng, num_points=4000, duration=0.8, steps=81,
                            motion_scale=0.6)
    ev_l, ev_r = tsyn.simulate_stereo_events(
        scene, rig.left.params.P.double().numpy(),
        rig.right.params.P.double().numpy(), W, H, pixel_threshold=0.75,
        rng=rng)
    ticks = np.arange(TICK, 0.8, TICK)[:N_TICKS]
    return rig, scene, ticks, (tev.frame_events(ev_l, ticks, 3000),
                               tev.frame_events(ev_r, ticks, 3000))


def pick(frames, sl):
    return {k: v[sl] for k, v in frames.items() if k != "dropped"}


def bootstrap(system, ticks, fl, fr):
    k0 = 0
    while system.status.value != "WORKING" and k0 + ROLL <= len(ticks):
        sl = slice(k0, k0 + ROLL)
        system.process_ticks(ticks[sl], pick(fl, sl), pick(fr, sl),
                             do_mapping=True)
        k0 += ROLL
    assert system.status.value == "WORKING"     # either package's enum
    return k0


def run_resident(system, ticks, fl, fr, R, k0, stop=None):
    """Whole dispatches from k0 to stop; returns (each dispatch's sync
    summary, the next tick)."""
    loop = tres.ResidentLoop(system, ticks_per_roll=ROLL,
                             rolls_per_dispatch=R)
    loop.start()
    outs, stop = [], stop or len(ticks)
    while k0 + R * ROLL <= stop:
        sl = slice(k0, k0 + R * ROLL)
        loop.run(ticks[sl], pick(fl, sl), pick(fr, sl))
        outs.append(loop.sync())
        k0 += R * ROLL
    loop.finish()
    return outs, k0


def ate_of(traj, scene, n=None):
    t, T = traj
    t, T = t[:n], T[:n]
    gt = np.stack([tsyn.interpolate_gt_pose(scene, x) for x in t])
    return float(ate_rmse(t, T, t, gt, align=True))


def rot_diff(a, b):
    """Angle (rad) between two poses' rotations, exact near zero."""
    E = a[:3, :3] @ b[:3, :3].T
    w = 0.5 * np.array([E[2, 1] - E[1, 2], E[0, 2] - E[2, 0],
                        E[1, 0] - E[0, 1]])
    return float(np.arctan2(np.linalg.norm(w), (np.trace(E) - 1) / 2))


# -- (a) the device-side pose guard ------------------------------------------

GUARD_CFG = TrackingNodeConfig(max_speed_mps=1.0, max_ang_speed_rps=1.0,
                               max_consecutive_rejects=3)


def _moved(T, dx=0.0, angle=0.0):
    T = T.copy()
    T[0, 3] += dx
    c, s = np.cos(angle), np.sin(angle)
    T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ T[:3, :3]
    return T


# name, T_est from T_cur, tick offset from the newest table time, consec
GUARD_CASES = {
    "accept": (lambda T: _moved(T, dx=0.005), 0.01, 0),
    "too_fast": (lambda T: _moved(T, dx=0.5), 0.01, 1),
    "too_fast_rotation": (lambda T: _moved(T, angle=0.5), 0.01, 0),
    "non_rigid": (lambda T: np.diag([1.5, 1.5, 1.5, 1.0]) @ T, 0.01, 1),
    "nan": (lambda T: np.where(np.eye(4) > 0, np.nan, T), 0.01, 1),
    "reanchor": (lambda T: _moved(T, dx=0.5), 0.01, 3),
    # dt 0 clamps to 1 / tracking_rate_hz: 0.015 m is then slow enough
    "dt_clamp": (lambda T: _moved(T, dx=0.015), 0.0, 0),
}


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_guard_append_matches_jax(case):
    make_est, dt, consec = GUARD_CASES[case]
    rng = np.random.default_rng(3)
    S = 8
    ptimes = (0.2 + 0.01 * np.arange(S)).astype(np.float32)
    ptab = np.stack([_moved(np.eye(4), dx=0.01 * i,
                            angle=rng.uniform(-0.1, 0.1))
                     for i in range(S)]).astype(np.float32)
    T_cur = ptab[-1].astype(np.float64)
    T_est = make_est(T_cur).astype(np.float32)
    t_k = np.float32(ptimes[-1] + dt)
    args = (T_est, ptab[-1], t_k, ptimes, ptab, consec, 5)
    got = tres._guard_append(
        *(torch.from_numpy(np.asarray(a)) for a in args[:5]),
        torch.tensor(consec, dtype=torch.int32),
        torch.tensor(5, dtype=torch.int32), GUARD_CFG)
    want = jres._guard_append(
        *(jnp.asarray(a) for a in args[:5]), jnp.int32(consec), jnp.int32(5),
        GUARD_CFG)
    T_new, pt, pT, c, n, acc = (np.asarray(x) for x in want)
    assert bool(got[5]) == bool(acc)
    assert int(got[3]) == int(c) and int(got[4]) == int(n)
    np.testing.assert_allclose(got[0].numpy(), T_new, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), pt, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), pT, atol=1e-6)
    expect = {"accept": True, "too_fast": False, "too_fast_rotation": False,
              "non_rigid": False, "nan": False, "reanchor": True,
              "dt_clamp": True}
    assert bool(acc) == expect[case]


# -- (b) the world-correction mirror -----------------------------------------

def test_correct_body_matches_jax():
    rng = np.random.default_rng(5)
    f32 = np.float32
    poses = lambda *s: se3_exp(torch.tensor(
        rng.normal(0, 0.5, s + (6,)), dtype=torch.float32)).numpy()
    fields = dict(T_world_cur=poses(), T_world_prev=poses(),
                  T_world_frame=poses(), pose_tab=poses(6),
                  ref_pts=rng.normal(0, 2, (9, 12, 3)).astype(f32))
    T_world_cam = poses(3, 7)
    corr = poses().astype(np.float64)
    none = lambda cls: {f.name: None for f in dataclasses.fields(cls)}
    port = tres.ResidentState(**dict(
        none(tres.ResidentState),
        history=tdr.DepthEstimates(**dict(
            none(tdr.DepthEstimates),
            T_world_cam=torch.from_numpy(T_world_cam))),
        **{k: torch.from_numpy(v) for k, v in fields.items()}))
    jax_state = jres.ResidentState(**dict(
        none(jres.ResidentState),
        history=jdr.DepthEstimates(**dict(
            none(jdr.DepthEstimates), T_world_cam=jnp.asarray(T_world_cam))),
        **{k: jnp.asarray(v) for k, v in fields.items()}))
    got = tres.ResidentLoop._correct_body(
        types.SimpleNamespace(system=types.SimpleNamespace(
            dtype=torch.float32)), port, corr)
    want = jres.ResidentLoop._correct_body(
        types.SimpleNamespace(system=types.SimpleNamespace(
            dtype=jnp.float32)), jax_state, corr)
    for name in fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got.history.T_world_cam.numpy(),
                               np.asarray(want.history.T_world_cam),
                               atol=1e-6)


# -- (c) the resident loop against the host path -----------------------------

@pytest.fixture(scope="module")
def port_resident(world):
    """The port's resident loop over the world (R = 2), from seed 3."""
    rig, scene, ticks, (fl, fr) = world
    system = EsvoSystem(rig, _loop_config(), device="cpu", seed=3)
    k0 = bootstrap(system, ticks, fl, fr)
    outs, _ = run_resident(system, ticks, fl, fr, R=2, k0=k0)
    return system, outs, k0


def test_resident_matches_host_path(world, port_resident):
    rig, scene, ticks, (fl, fr) = world
    res, outs, k0 = port_resident
    host = EsvoSystem(rig, _loop_config(), device="cpu", seed=3)
    assert bootstrap(host, ticks, fl, fr) == k0
    for k in range(k0, len(ticks), ROLL):
        sl = slice(k, k + ROLL)
        host.process_ticks(ticks[sl], pick(fl, sl), pick(fr, sl),
                           do_mapping=True)
    host.flush()
    (t_h, T_h), (t_r, T_r) = host.trajectory(), res.trajectory()
    assert len(t_r) == len(t_h) == len(ticks)
    np.testing.assert_array_equal(t_r, t_h)
    for a, b in zip(T_r, T_h):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 1e-5
        assert rot_diff(a, b) < 1e-5
    assert all(o["accepted"].all() and o["rolls_since_good"] == 0
               for o in outs)
    assert res.stats["tracking_rejects"] == host.stats["tracking_rejects"] \
        == 0
    assert outs[-1]["map_points"] == res.stats["map_points"] \
        == host.stats["map_points"]
    assert res.stats["fusions"] == host.stats["fusions"]
    assert res.stats["bm"] == host.stats["bm"]
    assert ate_of(res.trajectory(), scene) < 0.06


def test_select_ref_points_is_one_draw_and_a_selection(world, port_resident):
    system = port_resident[0]
    pts, ok, _ = system._current_ref_map()
    state = system._gen.get_state()
    a = system.select_ref_points(pts, ok)
    system._gen.set_state(state)
    b = system.select_from_scores(pts, ok, system.draw_ref_scores())
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert bool(a[1][:int(ok.sum())].all())


# -- (d) the slice against the JAX package -----------------------------------

def test_resident_slice_matches_jax(world, port_resident):
    rig, scene, ticks, (fl, fr) = world
    port, outs, k0 = port_resident
    jrig = jcam.make_ideal_rig(W, H, FX, FX, W / 2 - 0.5, H / 2 - 0.5, 0.1,
                               dtype=jnp.float32)
    jcfg = JSC(depth=JDP(max_iteration=8), bm=JBM(zncc_threshold=0.25),
               tracker=JReg(max_registration_points=500, batch_size=250),
               mapping=JMC(process_event_num=400, init_sgm_num_threshold=150,
                           std_var_vis_threshold=0.05, age_vis_threshold=0,
                           denoising=False, regularization=False))
    js = jsys.EsvoSystem(jrig, jcfg)
    assert bootstrap(js, ticks, fl, fr) == k0
    stop = k0 + 20
    loop = jres.ResidentLoop(js, ticks_per_roll=ROLL, rolls_per_dispatch=2)
    loop.start()
    for k in range(k0, stop, 2 * ROLL):
        sl = slice(k, k + 2 * ROLL)
        loop.run(ticks[sl], pick(fl, sl), pick(fr, sl))
        out = loop.sync()
    loop.finish()
    assert js.status == jsys.SystemStatus.WORKING
    assert port.status == SystemStatus.WORKING
    t_j, T_j = js.trajectory()
    gt = np.stack([tsyn.interpolate_gt_pose(scene, t) for t in t_j])
    ate_jax = float(jate_rmse(t_j, T_j, t_j, gt))
    ate_port = ate_of(port.trajectory(), scene, n=stop)
    assert ate_jax < 0.06 and ate_port < 0.06
    assert ate_port < max(2.0 * ate_jax, 0.06), (ate_port, ate_jax)
    pts_port = outs[1]["map_points"]         # after the same 20 ticks
    pts_jax = out["map_points"]
    assert pts_port > 0.5 * pts_jax and pts_jax > 0.5 * pts_port
    assert out["rolls_since_good"] == outs[1]["rolls_since_good"] == 0


# -- (e) hand-off, world correction, watchdog --------------------------------

def test_resident_state_handoff_continues_on_host(world):
    """finish() hands back a state the host path continues from: ref maps,
    pose table, fusion history all live."""
    rig, scene, ticks, (fl, fr) = world
    system = EsvoSystem(rig, _loop_config(), device="cpu", seed=4)
    k0 = bootstrap(system, ticks, fl, fr)
    _, k0 = run_resident(system, ticks, fl, fr, R=2, k0=k0, stop=k0 + 20)
    # the bootstrap's frame, then one a resident roll
    assert system.cycle.hist_slot == (1 + 4) % system.F
    for k in range(k0, len(ticks) - ROLL + 1, ROLL):
        sl = slice(k, k + ROLL)
        out = system.process_ticks(ticks[sl], pick(fl, sl), pick(fr, sl),
                                   do_mapping=True)
        assert out["poses"].shape == (ROLL, 4, 4)
    system.flush()
    assert system.status == SystemStatus.WORKING
    assert ate_of(system.trajectory(), scene) < 0.08
    assert np.all(np.diff(system.pose_times) > 0)


def test_resident_world_correction_mirrors_to_device(world):
    rig, scene, ticks, (fl, fr) = world
    system = EsvoSystem(rig, _loop_config(), device="cpu", seed=5)
    k0 = bootstrap(system, ticks, fl, fr)
    loop = tres.ResidentLoop(system, ticks_per_roll=ROLL,
                             rolls_per_dispatch=1)
    loop.start()
    sl = slice(k0, k0 + ROLL)
    loop.run(ticks[sl], pick(fl, sl), pick(fr, sl))
    loop.sync()
    corr = np.eye(4)
    corr[:3, 3] = [1.0, -2.0, 0.5]
    T_before = loop.state.T_world_cur.numpy().copy()
    ref_before = loop.state.ref_pts.clone()
    system.apply_world_correction(corr)
    np.testing.assert_allclose(loop.state.T_world_cur.numpy()[:3, 3],
                               T_before[:3, 3] + corr[:3, 3], atol=1e-5)
    torch.testing.assert_close(
        loop.state.ref_pts,
        ref_before + torch.tensor(corr[:3, 3], dtype=torch.float32))
    # and the loop keeps tracking in the corrected frame
    sl = slice(k0 + ROLL, k0 + 2 * ROLL)
    loop.run(ticks[sl], pick(fl, sl), pick(fr, sl))
    out = loop.sync()
    assert np.linalg.norm(out["poses"][-1][:3, 3] - corr[:3, 3]) < 0.5
    assert out["accepted"].all()
    loop.finish()
    assert loop._on_world_correction not in \
        system._world_correction_observers


def test_resident_sync_after_world_correction_keeps_it(world):
    """run -> apply_world_correction -> sync: the host mirrors are the
    corrected device state's, not the roll's uncorrected outputs."""
    rig, scene, ticks, (fl, fr) = world
    system = EsvoSystem(rig, _loop_config(), device="cpu", seed=5)
    k0 = bootstrap(system, ticks, fl, fr)
    loop = tres.ResidentLoop(system, ticks_per_roll=ROLL,
                             rolls_per_dispatch=1)
    loop.start()
    sl = slice(k0, k0 + ROLL)
    loop.run(ticks[sl], pick(fl, sl), pick(fr, sl))
    corr = np.eye(4)
    corr[:3, 3] = [1.0, -2.0, 0.5]
    system.apply_world_correction(corr)
    out = loop.sync()
    st = loop.state
    np.testing.assert_array_equal(system.T_world_cur,
                                  st.T_world_cur.double().numpy())
    np.testing.assert_array_equal(system.T_world_frame,
                                  st.T_world_frame.double().numpy())
    # the roll's published pose is the uncorrected one
    np.testing.assert_allclose(system.T_world_cur[:3, 3],
                               out["poses"][-1][:3, 3] + corr[:3, 3],
                               atol=1e-5)
    assert out["rolls_since_good"] == int(st.rolls_since_good) == 0
    assert int(st.num_rejects) == 0
    loop.finish()


def test_resident_timestamp_watchdog_raises(world):
    rig, scene, ticks, (fl, fr) = world
    system = EsvoSystem(rig, _loop_config(), device="cpu", seed=6)
    k0 = bootstrap(system, ticks, fl, fr)
    loop = tres.ResidentLoop(system, ticks_per_roll=ROLL,
                             rolls_per_dispatch=1)
    with pytest.raises(RuntimeError, match="start"):
        loop.run(ticks[k0:k0 + ROLL], pick(fl, slice(k0, k0 + ROLL)),
                 pick(fr, slice(k0, k0 + ROLL)))
    loop.start()
    sl = slice(k0, k0 + ROLL)
    with pytest.raises(tres.TimestampDiscontinuity, match="discontinuity"):
        loop.run(ticks[sl] + 100.0, pick(fl, sl), pick(fr, sl))
    with pytest.raises(ValueError, match="ticks"):
        loop.run(ticks[k0:k0 + 3], pick(fl, slice(k0, k0 + 3)),
                 pick(fr, slice(k0, k0 + 3)))
    # the static inputs keep the first roll's event capacity
    loop.run(ticks[sl], pick(fl, sl), pick(fr, sl))
    narrow = lambda f: {k: v[:, :100] for k, v in pick(f, sl).items()}
    with pytest.raises(ValueError, match="static buffer"):
        loop.stage(ticks[sl], narrow(fl), narrow(fr))


def test_start_requires_working():
    rig = make_ideal_rig(32, 24, 20.0, 20.0, 15.5, 11.5, 0.1, device="cpu")
    system = EsvoSystem(rig, _loop_config(), device="cpu")
    with pytest.raises(RuntimeError, match="WORKING"):
        tres.ResidentLoop(system, 5, 2).start()


def test_constant_is_built_once():
    a = constant((0.25, 0.5), torch.float32, torch.device("cpu"))
    assert a is constant((0.25, 0.5), torch.float32, torch.device("cpu"))
    assert torch.equal(a, torch.tensor([0.25, 0.5]))


# -- (f) the event stream ----------------------------------------------------

def _streams(n=5000, seed=0, t_end=1.0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, t_end, n))
    x = rng.integers(0, 240, n).astype(np.int32)
    y = rng.integers(0, 180, n).astype(np.int32)
    p = rng.random(n) > 0.5
    return tev.EventArray(t=t, x=x, y=y, p=p), jev.EventArray(t=t, x=x, y=y,
                                                              p=p)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_stream_matches_jax_frames(prefetch):
    ev, jev_ = _streams()
    sync = np.arange(0.01, 1.0, 0.01)
    cap = 80       # small enough that some frames overflow
    st = EventFrameStream(ev, sync, cap, prefetch=prefetch)
    ref = jstream.EventFrameStream(jev_, sync, cap, prefetch=prefetch)
    framed = tev.frame_events(ev, sync, cap)
    got, want = list(st), list(ref)
    assert len(st) == len(got) == len(want) == len(sync)
    for k, ((ts, f), (tj, fj)) in enumerate(zip(got, want)):
        assert ts == tj == pytest.approx(sync[k])
        for key in ("x", "y", "t", "p", "valid", "dropped"):
            np.testing.assert_array_equal(f[key], fj[key], err_msg=key)
            np.testing.assert_array_equal(f[key], framed[key][k])
    assert st.total_dropped == ref.total_dropped == framed["dropped"].sum()


def test_stream_rolls_match_jax():
    ev, jev_ = _streams(3000, seed=1)
    sync = np.arange(0.02, 0.9, 0.01)
    R, seen = 5, 0
    pairs = zip(EventFrameStream(ev, sync, 64).rolls(R),
                jstream.EventFrameStream(jev_, sync, 64).rolls(R))
    for (times, batch), (tj, bj) in pairs:
        r = len(times)
        assert r == len(tj) == min(R, len(sync) - seen)
        for key in ("x", "y", "t", "p", "valid", "dropped"):
            np.testing.assert_array_equal(batch[key], bj[key])
        seen += r
    assert seen == len(sync)


def test_stream_prefetch_propagates_errors():
    ev, _ = _streams(100)
    st = EventFrameStream(ev, np.array([0.5, 1.0]), 64, prefetch=2)
    orig = st.frame
    st.frame = lambda k: (_ for _ in ()).throw(RuntimeError("boom")) \
        if k == 1 else orig(k)
    with pytest.raises(RuntimeError, match="boom"):
        list(st)


def test_stream_rejects_absolute_timestamps():
    ev = tev.EventArray(t=np.array([1.4e9]), x=np.zeros(1, np.int32),
                        y=np.zeros(1, np.int32), p=np.ones(1, bool))
    with pytest.raises(ValueError, match="rebase"):
        EventFrameStream(ev, np.array([1.4e9 + 1]), 8)


def test_stream_memory_is_per_frame():
    """The stream does not materialize K x capacity buffers up front."""
    ev, _ = _streams(2000)
    st = EventFrameStream(ev, np.arange(0.001, 1.0, 0.001), 100_000,
                          prefetch=1)
    ts, f = next(iter(st))
    assert f["x"].shape == (100_000,)
