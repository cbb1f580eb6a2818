"""The port's EsvoSystem (runtime/system.py).

- MVStereo mode (ground-truth poses) against the JAX package's EsvoSystem
  on the same rig and events, over the SGM bootstrap and two WORKING
  mapping cycles (the JAX side's depth solve through its Pallas kernel
  in interpret mode, as in test_torch_mapping_cycle.py): the status
  sequence and the bootstrap's point count equal, map_estimates within
  2%; each depth frame (the bootstrap's naive fusion, then the WORKING
  rebuilds) made by the port's program from JAX's window at the fusion
  tolerances of test_torch_fusion.py, and the system's own frame on
  > 99% of the cells (its window differs where a one-ulp difference
  moves an SGM point's splat, or where the LM's accept test races,
  test_torch_lm.py).
- The closed loop of the port alone, through process_tick and through
  process_ticks in rolls of 5, on the world of tests/test_system.py:
  WORKING at the end, and the ATE under that test's bars (0.08 / 0.12 m).
- The WORKING cycle on static buffers (``MappingCycle.working_cycle``,
  eager on the CPU) against the cycle's stages called directly, through
  process_tick and process_ticks: every output, the stats and the global
  map bit for bit; published tensors never change afterwards.
- The live tick's body on static buffers (``EsvoSystem._tick_static``,
  eager on the CPU) against the plain stages (``_tick_plain``): every
  tick's outputs, the kept surface states, the trajectory, the scores
  drawn and the ref maps selected bit for bit; published states and
  surfaces never change afterwards.
- record_pose's guards, as tests/test_system.py checks them; reconfigure;
  and that nothing falls back to the CPU.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from esvo_tpu.io import synthetic as jsyn
from esvo_tpu.mapping.block_matching import BlockMatchConfig as JBM
from esvo_tpu.mapping.depth_refinement import DepthProblemConfig as JDP
from esvo_tpu.runtime import system as jsys
from esvo_tpu.runtime.config import MappingConfig as JMC
from esvo_tpu.runtime.config import SystemConfig as JSC
from esvo_tpu_torch import convert
from esvo_tpu_torch.eval.trajectory import ate_rmse, load_tum
from esvo_tpu_torch.geometry.camera import make_ideal_rig
from esvo_tpu_torch.io import synthetic as tsyn
from esvo_tpu_torch.io.events import frame_events
from esvo_tpu_torch.mapping.block_matching import BlockMatchConfig
from esvo_tpu_torch.mapping.depth_refinement import DepthProblemConfig
from esvo_tpu_torch.runtime.config import MappingConfig, SystemConfig
from esvo_tpu_torch.runtime.system import EsvoSystem, SystemStatus
from esvo_tpu_torch.tracking.registration import RegProblemConfig
from test_torch_fusion import _assert_grids
from test_torch_mapping_cycle import _rig

W, H, N, TICK, CAP = 120, 90, 256, 0.01, 1500


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the closed loop is thousands of small ops,
    and several test workers each running a full pool of threads slow it
    down tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
MAP_TICKS = (4, 9, 14)       # the bootstrap, then two WORKING cycles


def _frame(frames, k):
    return {key: v[k] for key, v in frames.items() if key != "dropped"}


def _mv_configs():
    mapping = dict(process_event_num=N, max_fusion_points=300,
                   std_var_vis_threshold=0.05, age_vis_threshold=0,
                   init_sgm_num_threshold=60)
    depth = dict(max_iteration=8, regularization_radius=2,
                 regularization_min_neighbours=2,
                 regularization_min_close_neighbours=1)
    jc = JSC(depth=JDP(lm_kernel="pallas", **depth),
             bm=JBM(zncc_threshold=0.25), mapping=JMC(**mapping))
    tc = SystemConfig(depth=DepthProblemConfig(**depth),
                      bm=BlockMatchConfig(zncc_threshold=0.25),
                      mapping=MappingConfig(**mapping))
    return jc, tc


@pytest.fixture(scope="module")
def mv_world():
    rig, (P_l, P_r) = _rig()
    rng = np.random.default_rng(11)
    scene = tsyn.make_scene(rng, num_points=2000, duration=0.2, steps=21,
                            motion_scale=0.6)
    ev_l, ev_r = tsyn.simulate_stereo_events(scene, P_l, P_r, W, H,
                                             pixel_threshold=0.75, rng=rng)
    ticks = np.arange(1, MAP_TICKS[-1] + 2) * TICK
    return rig, scene, ticks, (frame_events(ev_l, ticks, CAP),
                               frame_events(ev_r, ticks, CAP))


def test_mvstereo_matches_jax(mv_world):
    rig, scene, ticks, (fl, fr) = mv_world
    jc, tc = _mv_configs()
    js = jsys.EsvoSystem(rig, jc)
    ts = EsvoSystem(convert.rig_from_numpy(convert.rig_to_numpy(rig),
                                           device="cpu"), tc, device="cpu")
    assert (ts.N, ts.F) == (js.N, js.F)
    statuses = []
    for k, t in enumerate(ticks):
        gt = jsyn.interpolate_gt_pose(scene, float(t))
        args = (float(t), _frame(fl, k), _frame(fr, k))
        do_map = k in MAP_TICKS
        oj = js.process_tick(*args, gt_pose=gt, do_mapping=do_map)
        ot = ts.process_tick(*args, gt_pose=gt, do_mapping=do_map)
        statuses.append((ot["status"], oj["status"]))
        assert ts.status.value == js.status.value
        if not do_map:
            continue
        # the port's frame program on JAX's window gives JAX's frame at
        # the fusion tolerances
        hist = convert.state_from_numpy(
            {"history": convert.fields_to_numpy(js.history)},
            device="cpu")["history"]
        T_wf = ts._tensor(js.T_world_frame)
        if k == MAP_TICKS[0]:
            assert ot["sgm_points"] == oj["sgm_points"] >= 60
            assert ts.status == SystemStatus.WORKING
            _assert_grids(ts.cycle.seed_frame(hist, T_wf)[0], js.grid)
        else:
            assert abs(ot["map_estimates"] - oj["map_estimates"]) \
                <= 0.02 * oj["map_estimates"]
            assert oj["map_estimates"] > 0.2 * N
            _assert_grids(ts.cycle.rebuild_frame(hist, T_wf)[0], js.grid)
        # the system's own frame: its window differs by float32 rounding
        # (SGM points sit on integer pixels, where a one-ulp difference
        # moves a point's 2x2 splat) and by the LM's accept races
        occ_t, occ_j = ts.depth_map()[1], js.depth_map()[1]
        assert (occ_t == occ_j).mean() > 0.99
        assert ot["map_points"] == int(ts.grid.occupied.sum())
    assert [a for a, _ in statuses] == [b for _, b in statuses]
    np.testing.assert_array_equal(ts.trajectory()[1], js.trajectory()[1])
    assert ts.stats["fusions"] > 0


# -- the closed loop of the port alone -------------------------------------

LW, LH, LFX = 240, 180, 150.0


@pytest.fixture(scope="module")
def loop_world():
    """tests/test_system.py's world, made by the port's simulator."""
    rng = np.random.default_rng(7)
    rig = make_ideal_rig(LW, LH, LFX, LFX, LW / 2 - 0.5, LH / 2 - 0.5, 0.1,
                         device="cpu")
    scene = tsyn.make_scene(rng, num_points=4000, duration=0.8, steps=81,
                            motion_scale=0.6)
    ev_l, ev_r = tsyn.simulate_stereo_events(
        scene, rig.left.params.P.double().numpy(),
        rig.right.params.P.double().numpy(), LW, LH, pixel_threshold=0.75,
        rng=rng)
    ticks = np.arange(TICK, 0.8, TICK)
    return rig, scene, ticks, (frame_events(ev_l, ticks, 3000),
                               frame_events(ev_r, ticks, 3000))


def _loop_config():
    """tests/test_system.py's make_config, with 400 events a cycle and
    500 registration points in batches of 250."""
    return SystemConfig(
        depth=DepthProblemConfig(max_iteration=8),
        bm=BlockMatchConfig(zncc_threshold=0.25),
        tracker=RegProblemConfig(max_registration_points=500, batch_size=250),
        mapping=MappingConfig(process_event_num=400,
                              init_sgm_num_threshold=150,
                              std_var_vis_threshold=0.05,
                              age_vis_threshold=0, denoising=False,
                              regularization=False))


def _ate(system, scene):
    t_est, T_est = system.trajectory()
    gt = np.stack([tsyn.interpolate_gt_pose(scene, t) for t in t_est])
    return ate_rmse(t_est, T_est, t_est, gt, align=True)


def test_closed_loop_process_tick(loop_world, tmp_path):
    rig, scene, ticks, (fl, fr) = loop_world
    system = EsvoSystem(rig, _loop_config(), device="cpu",
                        emit_debug_maps=True)
    n_ticks, tracked = 60, 0
    for k in range(n_ticks):
        out = system.process_tick(float(ticks[k]), _frame(fl, k),
                                  _frame(fr, k), do_mapping=(k % 5 == 4))
        if "lm_stats" in out:
            tracked += 1
            assert out["tracking_rms"].shape == (10,)
            assert out["lm_stats"]["n_points"] == 500
        if k % 5 == 4:
            assert set(out["maps"]) >= {"inv_depth", "std_var", "age", "cost"}
            assert out["maps"]["inv_depth"].shape == (LH, LW, 3)
    assert system.status == SystemStatus.WORKING
    assert tracked == n_ticks - 5
    ate = _ate(system, scene)
    assert ate < 0.08, f"ATE {ate}"
    assert "reprojection" in system.render_debug_maps()
    assert len(system.global_map()) > 500

    system.save_trajectory(str(tmp_path / "traj.txt"))
    t, T = load_tum(str(tmp_path / "traj.txt"))
    np.testing.assert_allclose(T, system.trajectory()[1], atol=1e-6)
    path = system.save_depth_map(str(tmp_path / "depth"))
    assert len(np.loadtxt(path)) == int(system.grid.occupied.sum())


def test_closed_loop_process_ticks(loop_world):
    rig, scene, ticks, (fl, fr) = loop_world
    system = EsvoSystem(rig, _loop_config(), device="cpu")
    n_ticks, R = 40, 5
    for k0 in range(0, n_ticks, R):
        sl = slice(k0, k0 + R)
        out = system.process_ticks(
            ticks[sl], {k: v[sl] for k, v in fl.items() if k != "dropped"},
            {k: v[sl] for k, v in fr.items() if k != "dropped"},
            do_mapping=True)
        if k0 == 0:
            assert out["sgm_points"] >= 150 and "poses" not in out
        elif k0 >= 2 * R:
            assert "map_estimates" in out and out["poses"].shape == (R, 4, 4)
    assert system.flush() is not None
    assert system.status == SystemStatus.WORKING
    t_est, _ = system.trajectory()
    assert len(t_est) == n_ticks
    ate = _ate(system, scene)
    assert ate < 0.12, f"ATE {ate}"

    # a world correction moves every world-frame quantity together
    corr = np.eye(4)
    corr[:3, 3] = [0.5, -0.25, 1.0]
    before = (system.T_world_cur.copy(), system._ref_maps[-1][0].clone(),
              system.history.T_world_cam.clone(), system.global_map())
    system.apply_world_correction(corr)
    np.testing.assert_allclose(system.T_world_cur[:3, 3],
                               before[0][:3, 3] + corr[:3, 3])
    shift = torch.tensor(corr[:3, 3], dtype=torch.float32)
    torch.testing.assert_close(system._ref_maps[-1][0], before[1] + shift)
    torch.testing.assert_close(system.history.T_world_cam[..., :3, 3],
                               before[2][..., :3, 3] + shift)
    np.testing.assert_allclose(system.global_map(), before[3] + corr[:3, 3])


def test_reconfigure_and_watchdog(loop_world):
    rig, scene, ticks, (fl, fr) = loop_world
    system = EsvoSystem(rig, _loop_config(), device="cpu")
    for k in range(10):
        system.process_tick(float(ticks[k]), _frame(fl, k), _frame(fr, k),
                            do_mapping=(k % 5 == 4))
    assert system.status == SystemStatus.WORKING
    slot = system.cycle.hist_slot
    # shape-compatible change without reset keeps the live state
    cfg2 = dataclasses.replace(system.cfg, tracker=dataclasses.replace(
        system.cfg.tracker, max_iteration=6))
    system.reconfigure(cfg2, reset=False)
    assert system.status == SystemStatus.WORKING
    assert system.cycle.hist_slot == slot and system.cycle.cfg is cfg2
    cfg3 = dataclasses.replace(cfg2, mapping=dataclasses.replace(
        cfg2.mapping, process_event_num=320))
    system.reconfigure(cfg3, reset=False)      # shape change: reset anyway
    assert system.status == SystemStatus.INITIALIZATION and system.N == 320
    for k in range(10, 20):
        system.process_tick(float(ticks[k]), _frame(fl, k), _frame(fr, k),
                            do_mapping=(k % 5 == 4))
    assert system.status == SystemStatus.WORKING
    # a timestamp jump back resets on the offending tick
    count = system.reset_count
    system.process_tick(float(ticks[3]), _frame(fl, 3), _frame(fr, 3),
                        do_mapping=False)
    assert system.reset_count == count + 1
    assert system.status == SystemStatus.INITIALIZATION


def _cycle_by_stages(cycle, ts_l, ts_r, ev, pose_times, pose_tab, T_wf):
    """``MappingCycle.working_cycle`` through the cycle's stages called
    directly on tensors made from the host arrays (no static buffers)."""
    real = lambda a: torch.as_tensor(np.asarray(a), dtype=cycle.dtype)
    T = real(T_wf)
    est, n, bm_stats = cycle.mapping_estimate(
        ts_l, ts_r, torch.as_tensor(ev["x"]), torch.as_tensor(ev["y"]),
        real(ev["t"]), torch.as_tensor(ev["valid"]), real(pose_times),
        real(pose_tab), T)
    cycle.push_history(est)
    grid, pts, occ, nf, nd = cycle.rebuild_frame(cycle.history, T)
    counters = torch.stack([c.to(torch.int64) for c in (
        n, *bm_stats.values(), nf, nd, torch.sum(occ))])
    return grid, pts, occ, counters, tuple(bm_stats)


def _assert_same(a, b, path="out"):
    """Equal bit for bit (NaN matching NaN), recursively through dicts,
    lists, tuples, dataclasses of tensors, tensors and arrays."""
    if dataclasses.is_dataclass(a):
        a, b = vars(a), vars(b)
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{path}[{i}]")
    elif isinstance(a, (torch.Tensor, np.ndarray)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(
            a, b, equal_nan=a.dtype.kind == "f"), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("roll", [1, 5], ids=["process_tick",
                                              "process_ticks"])
def test_buffered_cycle_equals_its_stages(loop_world, roll):
    """The WORKING cycle on static buffers (``working_cycle``, its body
    eager on the CPU) against the cycle's stages called directly in a
    second system: every tick's outputs (``map_estimates``, ``bm_stats``
    and the surfaces among them), the stats, the global map, the
    trajectory, the window and the grid bit for bit, over the bootstrap,
    WORKING cycles, a world correction and a degrade with its
    re-bootstrap. Tensors published before two more cycles read the
    same after them, and no two REF_HISTORY maps share storage."""
    rig, scene, ticks, (fl, fr) = loop_world
    systems = [EsvoSystem(rig, _loop_config(), device="cpu")
               for _ in range(2)]
    ref = systems[1]
    ref.cycle.working_cycle = functools.partial(_cycle_by_stages, ref.cycle)
    kept = None
    for k0 in range(0, 40, roll):
        outs = []
        for sy in systems:
            if roll == 1:
                outs.append(sy.process_tick(float(ticks[k0]),
                                            _frame(fl, k0), _frame(fr, k0),
                                            do_mapping=k0 % 5 == 4))
            else:
                sl = slice(k0, k0 + roll)
                outs.append(sy.process_ticks(
                    ticks[sl], {k: v[sl] for k, v in fl.items()
                                if k != "dropped"},
                    {k: v[sl] for k, v in fr.items() if k != "dropped"},
                    do_mapping=True))
        _assert_same(*outs, path=f"tick {k0}")
        got = systems[0]
        if k0 // 5 == 2:
            kept = [(t, t.clone()) for a in (got.history, got.grid)
                    for t in vars(a).values()]
        if k0 // 5 == 4:
            corr = np.eye(4)
            corr[:3, 3] = [0.02, -0.01, 0.03]
            for sy in systems:
                sy.apply_world_correction(corr)
        if k0 // 5 == 5:
            for sy in systems:
                sy._degrade()
    for sy in systems:
        sy.flush()
    assert got.status == SystemStatus.WORKING and got.reset_count == 1
    assert len(got.cycle._static) == 1 and not ref.cycle._static
    for name in ("stats", "status", "grid", "history", "T_world_frame",
                 "_frames_filled", "_ref_maps"):
        _assert_same(getattr(got, name), getattr(ref, name), name)
    _assert_same(got.cycle.hist_slot, ref.cycle.hist_slot)
    _assert_same(got.global_map(), ref.global_map())
    _assert_same(got.trajectory(), ref.trajectory())
    for before, copy in kept:
        _assert_same(before, copy)
    ring = [p.untyped_storage().data_ptr() for p, _, _ in got._ref_maps]
    assert len(set(ring)) == len(ring)


def _recording(system, log: list) -> None:
    """Wrap the system's draw_ref_scores and select_ref_points (instance
    attributes over the methods, as the benchmark's tick driver does):
    each call's scores and ref map go to `log`."""
    draw, select = system.draw_ref_scores, system.select_ref_points

    def draw_scores():
        log.append(("scores", draw()))
        return log[-1][1]

    def select_points(pts_world, pt_valid):
        log.append(("ref_map", (pts_world, pt_valid)))
        return select(pts_world, pt_valid)
    system.draw_ref_scores, system.select_ref_points = draw_scores, \
        select_points


def _padded(frame: dict, pad: int) -> dict:
    """The frame at a larger capacity: `pad` invalid lanes appended."""
    return {k: np.concatenate([v, np.zeros(pad, v.dtype)])
            for k, v in frame.items()}


def test_static_tick_equals_its_stages(loop_world):
    """The live tick's body on static buffers (``_tick_static``, eager on
    the CPU) against the plain stages (``_tick_plain``) in a second
    system: every tick's outputs (both surfaces, the pose's rms and
    point count among them), the kept surface states, the trajectory,
    the stats and the window bit for bit, and the same scores drawn
    and ref maps selected, over the bootstrap, tracked and mapping
    ticks, a world correction, a roll of process_ticks, a second event
    capacity, a known-pose tick and a watchdog reset. The states and
    surfaces published on one tick read the same two ticks later."""
    rig, scene, ticks, (fl, fr) = loop_world
    systems = [EsvoSystem(rig, _loop_config(), device="cpu")
               for _ in range(2)]
    got, ref = systems
    # the card's body on the CPU: process_tick takes _tick_plain here
    got._tick_plain = got._tick_static
    logs = ([], [])
    for sy, log in zip(systems, logs):
        _recording(sy, log)
    kept = None
    for k in range(35):
        t = float(ticks[k])
        if k == 26:
            t = float(ticks[3])            # the watchdog resets
        if k == 14:
            corr = np.eye(4)
            corr[:3, 3] = [0.02, -0.01, 0.03]
            for sy in systems:
                sy.apply_world_correction(corr)
        if 15 <= k < 20:
            if k == 15:
                sl = slice(15, 20)
                outs = [sy.process_ticks(
                    ticks[sl], {n: v[sl] for n, v in fl.items()
                                if n != "dropped"},
                    {n: v[sl] for n, v in fr.items() if n != "dropped"})
                    for sy in systems]
                _assert_same(*outs, path="roll")
            continue
        pad = 200 if k == 21 else 0
        gt = tsyn.interpolate_gt_pose(scene, t) if k == 25 else None
        outs = [sy.process_tick(t, _padded(_frame(fl, k), pad),
                                _padded(_frame(fr, k), pad), gt_pose=gt,
                                do_mapping=k % 5 == 4) for sy in systems]
        _assert_same(*outs, path=f"tick {k}")
        for a, b in ((got.ts_state_left, ref.ts_state_left),
                     (got.ts_state_right, ref.ts_state_right)):
            _assert_same(a, b, path=f"tick {k} states")
        if k == 10:
            assert "lm_stats" in outs[0]
            kept = [(t_, t_.clone()) for t_ in (
                *vars(got.ts_state_left).values(),
                *vars(got.ts_state_right).values(), outs[0]["ts_left"],
                outs[0]["ts_right"])]
        if k == 12:
            for before, copy in kept:
                _assert_same(before, copy)
    assert got.reset_count == ref.reset_count == 2
    assert got.status == SystemStatus.WORKING
    for name in ("stats", "status", "T_world_frame", "history",
                 "_ref_maps"):
        _assert_same(getattr(got, name), getattr(ref, name), name)
    _assert_same(got.trajectory(), ref.trajectory())
    _assert_same(*logs, path="draws")
    assert sum(kind == "scores" for kind, _ in logs[0]) > 10
    # bodies: tracked and render-only at 3,000 events, tracked at 3,200
    assert sorted((k[1] is not None, k[0][0]) for k in got._ticks) == [
        (False, (3000,)), (True, (3000,)), (True, (3200,))]
    assert not ref._ticks
    static = {b.data.untyped_storage().data_ptr() for st in
              got._ticks.values() for b in (st.state, st.out)}
    assert not static & {t_.untyped_storage().data_ptr() for t_ in (
        *vars(got.ts_state_left).values(), *outs[0].values())
        if isinstance(t_, torch.Tensor)}


# -- record_pose guards, as tests/test_system.py -----------------------------

def _guard_system(**tracking):
    rig = make_ideal_rig(LW, LH, LFX, LFX, LW / 2 - 0.5, LH / 2 - 0.5, 0.1,
                         device="cpu")
    cfg = _loop_config()
    cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(
        cfg.tracking, **tracking))
    return EsvoSystem(rig, cfg, device="cpu")


def test_record_pose_rejects_degenerate():
    system = _guard_system(max_speed_mps=5.0)
    T = np.eye(4)
    T[:3, 3] = [1.0, 2.0, 3.0]
    system.record_pose(10.0, T)
    n_ok = len(system.pose_times)
    system.record_pose(10.2, np.zeros((4, 4)))         # singular
    bad = np.eye(4)
    bad[0, 3] = np.nan
    system.record_pose(10.3, bad)                      # non-finite
    scaled = np.eye(4) * 1.5
    scaled[3, 3] = 1.0
    system.record_pose(10.4, scaled)                   # det != 1
    assert system.stats["tracking_rejects"] == 3
    assert len(system.pose_times) == n_ok
    np.testing.assert_array_equal(system.T_world_cur, T)
    jump = T.copy()
    jump[:3, 3] += [4.0, 0.0, 0.0]
    system.record_pose(10.5, jump)
    assert system.stats["tracking_rejects"] == 4
    np.testing.assert_array_equal(system.T_world_cur, T)
    slow = T.copy()
    slow[:3, 3] += [0.02, 0.0, 0.0]
    system.record_pose(10.6, slow)
    np.testing.assert_array_equal(system.T_world_cur, slow)
    far_later = T.copy()
    far_later[:3, 3] += [3.0, 0.0, 0.0]
    system.record_pose(12.0, far_later)
    np.testing.assert_array_equal(system.T_world_cur, far_later)
    spin = far_later.copy()
    spin[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]  # 90 deg in 10 ms
    system.record_pose(12.01, spin)
    assert system.stats["tracking_rejects"] == 5


def test_pose_table_follows_the_pose_lists():
    """The pose table a mapping cycle reads holds the newest stamped
    poses of the pose lists, padded by the last pose at increasing times:
    before and past the table's size, after several poses at once, after
    a world correction (a list rebound), an extend (as ResidentLoop.finish
    does) by fewer and by more poses than the table holds, and a reset."""
    system = _guard_system()
    system.pose_table_size = 8
    t = [0.0]

    def add(k):
        for _ in range(k):
            t[0] += 0.01
            T = system.T_world_cur.copy()
            T[:3, 3] += [1e-3, -2e-3, 5e-4]
            system.record_pose(t[0], T)

    def check():
        S = system.pose_table_size
        times, poses = system._pose_arrays()
        n = min(len(system.pose_times), S)
        assert times.dtype == np.float64 and times.shape == (S,)
        assert poses.shape == (S, 4, 4)
        np.testing.assert_array_equal(times[:n], system.pose_times[-n:])
        np.testing.assert_array_equal(poses[:n],
                                      np.stack(system.pose_list[-n:]))
        np.testing.assert_array_equal(
            poses[n:], np.repeat(poses[n - 1:n], S - n, axis=0))
        assert np.all(np.diff(times[n - 1:]) > 0)

    for _ in range(12):
        add(1)
        check()
    add(3)
    check()
    system.apply_world_correction(np.diag([1.0, -1.0, -1.0, 1.0]))
    check()
    add(2)
    check()
    for k in (5, 12):
        times = t[0] + 0.01 * np.arange(1, k + 1)
        t[0] = float(times[-1])
        system.pose_times.extend(times.tolist())
        system.pose_list.extend([system.T_world_cur.copy()] * k)
        check()
    system.reset()
    check()
    add(1)
    check()
    assert len(system.pose_times) == 2


def test_record_pose_reanchors_after_sustained_rejections():
    system = _guard_system(max_speed_mps=1.0, max_consecutive_rejects=5)
    system.record_pose(0.0, np.eye(4))
    with pytest.warns(UserWarning, match="re-anchoring"):
        for k in range(1, 12):
            Tk = np.eye(4)
            Tk[0, 3] = 10.0 * k * 0.1
            system.record_pose(k * 0.1, Tk)
    assert system.T_world_cur[0, 3] > 0.0
    assert system.stats["tracking_rejects"] >= 5


def test_no_cpu_fallback_and_no_mesh(tmp_path):
    """Nothing falls back to the CPU; a mesh that is no DeviceMesh raises
    TypeError, and a 1-rank mesh's system keeps the same surfaces as the
    plain one, bit for bit."""
    import torch_parallel_ranks as ranks
    rig = make_ideal_rig(32, 24, 20.0, 20.0, 15.5, 11.5, 0.1, device="cpu")
    if torch.cuda.is_available():
        assert EsvoSystem(rig).device.type == "cuda"
    else:
        # the default device is cuda: without one the system fails to
        # build instead of running on the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            EsvoSystem(rig)
    with pytest.raises(TypeError, match="DeviceMesh"):
        EsvoSystem(rig, device="cpu", mesh=object())
    rng = np.random.default_rng(0)
    n = 301
    frames = [{"x": rng.integers(0, 32, n), "y": rng.integers(0, 24, n),
               "t": np.full(n, 0.01 * (k + 1), np.float32) + rng.uniform(
                   0, 0.005, n).astype(np.float32),
               "p": rng.random(n) > 0.5, "valid": rng.random(n) > 0.1}
              for k in range(3)]
    with ranks.one_rank_mesh(tmp_path) as mesh:
        systems = [EsvoSystem(rig, device="cpu", mesh=m) for m in (mesh, None)]
        for k, f in enumerate(frames):
            for s in systems:
                s.process_tick(0.01 * (k + 1), f, f, do_mapping=False)
    for a, b in ((systems[0].ts_state_left, systems[1].ts_state_left),
                 (systems[0].ts_state_right, systems[1].ts_state_right)):
        torch.testing.assert_close(a.last_t_pos, b.last_t_pos, rtol=0,
                                   atol=0)
        torch.testing.assert_close(a.last_t_neg, b.last_t_neg, rtol=0,
                                   atol=0)
