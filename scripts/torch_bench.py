"""Headline benchmark of esvo_tpu_torch: events/s through the mapping
pipeline, the PyTorch/CUDA counterpart of the JAX package's bench.py.

Measures the throughput of the hot path - time-surface render + stereo
block matching + per-event inverse-depth LM + culling + window fusion -
on synthetic 240x180 (DAVIS240C geometry, the rpg benchmark sensor)
event data, with a per-stage breakdown (ts/bm/solve/fuse), a DSEC-scale
(640x480, D=151, 8192 events) cycle time, a roofline per stage (the
least HBM bytes and float32 operations the stage's inputs need, counted
from the shapes, against the H100's published peaks) and a closed-loop
system metric: ticks/s and ATE of the device-resident loop
(runtime/resident.py, one CUDA graph a roll) on a synthetic scene, swept
over 5 / 10 / 25 / 50-tick dispatches, beside the host-driven roll path.

Baseline: reference ESVO's mapper processes PROCESS_EVENT_NUM=1000 events
per cycle at 20 Hz on a 6-thread i7-8750H (cfg/mapping/mapping_rpg.yaml:18,
:21) => 20,000 events/s for the same pipeline stages, with the reference
LM trip count max_iteration=10 (cfg/mapping/mapping_rpg.yaml:27).

Fusion is timed on the real post-solve estimates with a steady-state full
history (every slot holds a real frame's estimates).

Runs on the CUDA card; ``--device cpu`` runs the same code on the CPU
(the tests do, at small sizes through the functions below). Without a
card and without ``--device cpu`` it raises. Every failure exits
non-zero.

    python3 scripts/torch_bench.py [--device cuda|cpu]

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"stages", "system", "device"}; "device" holds the card's name and power
limit as nvidia-smi reports them.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from esvo_tpu_torch.eval.trajectory import ate_rmse  # noqa: E402
from esvo_tpu_torch.geometry.camera import make_ideal_rig  # noqa: E402
from esvo_tpu_torch.geometry.se3 import interpolate_pose_table  # noqa: E402
from esvo_tpu_torch.io.events import frame_events  # noqa: E402
from esvo_tpu_torch.io.synthetic import (  # noqa: E402
    interpolate_gt_pose, make_scene, simulate_stereo_events)
from esvo_tpu_torch.mapping import block_matching as bm  # noqa: E402
from esvo_tpu_torch.mapping import depth_refinement as dr  # noqa: E402
from esvo_tpu_torch.mapping import fusion as fu  # noqa: E402
from esvo_tpu_torch.mapping.initialization import SGMConfig  # noqa: E402
from esvo_tpu_torch.runtime.config import (  # noqa: E402
    MappingConfig, SystemConfig)
from esvo_tpu_torch.runtime.resident import ResidentLoop  # noqa: E402
from esvo_tpu_torch.runtime.system import (  # noqa: E402
    EsvoSystem, MappingCycle, SystemStatus)
from esvo_tpu_torch.surface import time_surface as tsf  # noqa: E402

BASELINE_EVENTS_PER_SEC = 20_000.0
# one H100 SXM, NVIDIA's data sheet, dense rates at the 700 W limit:
# float32 outside the tensor cores (every stage here runs there:
# utils/precision.py pins full float32), bf16 on the tensor cores (the
# card's headline peak, the kind of peak bench.py's "mfu" divides by),
# HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
F32 = torch.float32


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------

def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device that is not there
    raises (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "false); pass --device cpu to run on the CPU")
    return dev


def device_info(device) -> dict:
    """What every number of a run is stamped with: on the card its name
    and power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives them."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dict(platform="cpu", name=platform.processor() or "cpu",
                    power_limit=None, threads=torch.get_num_threads())
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    line = out.stdout.strip().splitlines()[dev.index or 0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return dict(platform="gpu", name=name, power_limit=limit,
                kind=torch.cuda.get_device_name(dev),
                count=torch.cuda.device_count())


def device_stamp(info: dict) -> str:
    """One line naming the device of a run, for text output."""
    if info["platform"] == "gpu":
        return f"device: {info['name']}, {info['power_limit']}"
    return f"device: cpu ({info['name']}, {info['threads']} threads)"


def block() -> None:
    """Wait for everything queued on the card, all outputs included (a
    no-op where this process has not used CUDA)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the mapping pipeline
# ---------------------------------------------------------------------------

def make_world(W, H, N, disp, rng, device="cuda"):
    """An ideal rig, a textured surface pair shifted by `disp` pixels and
    N events at integer pixels (bench.py's world)."""
    rig = make_ideal_rig(W, H, 200.0, 200.0, W / 2 - 0.5, H / 2 - 0.5,
                         0.1, dtype=F32, device=device)
    base = rng.uniform(0, 255, size=(H, W + 64)).astype(np.float32)
    k = np.ones(5) / 5
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    t = lambda a, dtype=F32: torch.as_tensor(np.ascontiguousarray(a),
                                             dtype=dtype, device=device)
    ts_l = t(base[:, 32:32 + W])
    ts_r = t(base[:, 32 + disp:32 + disp + W])
    ev_x = t(rng.integers(20, W - 20, N), torch.int32)
    ev_y = t(rng.integers(10, H - 10, N), torch.int32)
    ev_t = t(np.sort(rng.uniform(0.0, 0.01, N)))
    ev_p = t(rng.random(N) > 0.5, torch.bool)
    return rig, ts_l, ts_r, ev_x, ev_y, ev_t, ev_p


def time_fn(fn, args, reps, passes=2):
    """Best-of-`passes` mean rep time after one warm-up call; each pass
    ends in a synchronize of the card, so the whole output is done."""
    out = fn(*args)
    block()
    best = float("inf")
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        block()
        best = min(best, (time.perf_counter() - t0) / reps)
    return best, out


def build_cycle(rig, W, H, N, F, bm_cfg, dp_cfg, fu_cfg, surf_cfg, ts_tex_l,
                ts_tex_r):
    """Full mapping cycle (TS tick + BM + depth LM + cull + fuse) and the
    individual stages for the breakdown, composed as bench.py composes
    them (kernel K3 in the render, K1 and K2 in the solve)."""
    dev = ts_tex_l.device
    pose_t = torch.as_tensor(np.linspace(-0.05, 0.05, 32), dtype=F32,
                             device=dev)
    pose_T = torch.eye(4, dtype=F32, device=dev).expand(32, 4, 4)
    eye4 = torch.eye(4, dtype=F32, device=dev)

    def stage_ts(ts_state, ev_x, ev_y, ev_t, ev_p, ev_valid):
        batch = tsf.EventBatch(x=ev_x, y=ev_y, t=ev_t, p=ev_p,
                               valid=ev_valid)
        ts_state = tsf.insert_events(ts_state, batch)
        surf = tsf.render_backward(ts_state, ev_t[-1], rig.left, surf_cfg)
        return ts_state, 0.5 * (surf + ts_tex_l)

    def stage_bm(ts_l, ev_x, ev_y, ev_t, ev_valid):
        x_rect = rig.left.lut[ev_y.long(), ev_x.long()]
        return bm.match_events(ts_l, ts_tex_r, x_rect, x_rect, ev_t,
                               ev_valid, rig.left.mask, rig, bm_cfg)

    def stage_solve(ts_l, matches, ev_t):
        T_wv = interpolate_pose_table(pose_t, pose_T, ev_t)
        est = dr.solve(matches.x_left, T_wv, T_wv, matches.inv_depth,
                       matches.valid, ev_t, ts_l, ts_tex_r, rig, dp_cfg)
        return dr.point_culling(est, 0.03, 20.0 ** 2 * dp_cfg.patch_area,
                                0.2, 2.0)

    def stage_fuse(history, slot, est):
        history = MappingCycle.write_history(
            history, est, torch.as_tensor(slot, dtype=torch.int64,
                                          device=dev))
        flat = history.map(lambda a: a.reshape((-1,) + a.shape[2:]))
        grid = fu.empty_grid(H, W, F32, dev)
        cand = fu.propagate_points(flat, eye4, rig.left, fu_cfg)
        grid, nfused, _ = fu.fuse_frame(grid, cand, rig.left, fu_cfg)
        return history, grid.inv_depth, nfused

    def cycle(ts_state, history, slot, ev_x, ev_y, ev_t, ev_p, ev_valid):
        ts_state, ts_l = stage_ts(ts_state, ev_x, ev_y, ev_t, ev_p, ev_valid)
        matches = stage_bm(ts_l, ev_x, ev_y, ev_t, ev_valid)
        est = stage_solve(ts_l, matches, ev_t)
        history, inv_d, nfused = stage_fuse(history, slot, est)
        return ts_state, history, inv_d, nfused

    def empty_history():
        z = lambda *shape, dtype=F32: torch.zeros(shape, dtype=dtype,
                                                  device=dev)
        return dr.DepthEstimates(
            x=z(F, N, 2), inv_depth=-torch.ones((F, N), dtype=F32,
                                                device=dev),
            variance=z(F, N), scale2=z(F, N), nu=z(F, N), residual=z(F, N),
            age=z(F, N, dtype=torch.int32), p_cam=z(F, N, 3),
            T_world_cam=eye4.expand(F, N, 4, 4).clone(),
            valid=z(F, N, dtype=torch.bool))

    return cycle, stage_ts, stage_bm, stage_solve, stage_fuse, empty_history


def roofline_counts(W, H, N, F, bm_cfg, dp_cfg) -> dict:
    """(least HBM bytes, least float32 operations) of each stage, from
    the shapes alone, whatever implements the stage.

    Bytes are bench.py's min_hbm formulas (every input read once, every
    output written once). Operations count the arithmetic the inputs
    need, each formula beside its stage; an exp, a sqrt or a division
    counts as one."""
    mg = dp_cfg.window_margin
    Wy = dp_cfg.patch_size_y + 1 + 2 * mg
    Wx = dp_cfg.patch_size_x + 1 + 2 * mg
    P_bm = bm_cfg.patch_size_x * bm_cfg.patch_size_y
    D = len(range(bm_cfg.min_disparity, bm_cfg.max_disparity + 1,
                  bm_cfg.step))
    P_lm = dp_cfg.patch_area
    it = dp_cfg.max_iteration
    return {
        # bytes: insert 2 grids r+w; render: grid r, image w, remap r+w.
        # ops: one max a scattered event; a pixel's decay (max of the
        # polarity grids, dt, clamp, divide, exp) and 8-bit levels
        # (scale, round, clamp): 8; its bilinear remap: 15 (K3's count in
        # chip_smoke.py); the blend with the texture: 2
        "ts": ((8 * H * W + 4 * N) * 4, N + H * W * (8 + 15 + 2)),
        # bytes: both surfaces read once + per-event match outputs.
        # ops: a patch pixel's left sums (l, l*l): 3 an event; its
        # right sums (l*r, r, r*r) at every disparity: 5; the ZNCC from
        # the sums and the argmin step: 12 an (event, disparity)
        "bm": ((2 * H * W + 16 * N) * 4,
               N * (3 * P_bm + D * (5 * P_bm + 12))),
        # bytes: both windows gathered once (from the surfaces) + outputs.
        # ops: a patch pixel at each of the it + 1 evaluations: two
        # bilinear samples with their d-derivatives (36), the Tdist
        # weight and cost (11), one scale fixed-point trip (7); at each
        # of the it steps g and h (4); J^T J once (2); an event's pose
        # interpolation, finalization and culling: 85
        "solve": ((2 * N * Wy * Wx + 2 * H * W + 16 * N) * 4,
                  N * (P_lm * ((it + 1) * (36 + 11 + 7) + 4 * it + 2)
                       + 85)),
        # bytes: history read once + 8-plane grid written once +
        # points/poses. ops: a history point's propagation into the frame
        # (back-projection, transform, projection, variance): 45; its
        # Student-t fold into a pixel: 25
        "fuse": ((30 * F * N + 9 * H * W) * 4, F * N * (45 + 25)),
    }


def roofline(counts: dict, times: dict, device) -> dict:
    """Per stage: gflops and min_hbm_gb from the counts; on the card the
    shares of the published peaks in the measured time (mfu against the
    bf16 tensor-core peak, flops_frac against float32, membw_frac against
    HBM). A share above 1 is a counting fault and raises. A CPU run has
    no device shares (None)."""
    on_card = torch.device(device).type == "cuda"
    out = {}
    for name, (nbytes, flops) in counts.items():
        t = times[name]
        if t <= 0:
            raise ValueError(f"{name}: non-positive time {t}")
        shares = dict(mfu=flops / t / PEAK_BF16_FLOPS,
                      flops_frac=flops / t / PEAK_F32_FLOPS,
                      membw_frac=nbytes / t / PEAK_HBM_BYTES)
        if on_card and max(shares.values()) > 1.0:
            raise AssertionError(f"{name}: a roofline share above 1 is a "
                                 f"counting fault: {shares}")
        out[name] = dict(gflops=flops / 1e9, min_hbm_gb=nbytes / 1e9,
                         **{k: v if on_card else None
                            for k, v in shares.items()})
    return out


def bench_pipeline(W, H, N, disp, bm_cfg, dp_cfg, reps, rng,
                   device="cuda"):
    dev = resolve_device(device)
    rig, ts_l_tex, ts_r_tex, ev_x, ev_y, ev_t, ev_p = \
        make_world(W, H, N, disp, rng, dev)
    F = 4
    surf_cfg = tsf.TimeSurfaceConfig()
    ev_valid = torch.ones(N, dtype=torch.bool, device=dev)
    ts_state = tsf.init_state(H, W, dev)

    fu_cfg = fu.FusionConfig()
    (cycle0, stage_ts, stage_bm, stage_solve, stage_fuse,
     empty_history) = build_cycle(rig, W, H, N, F, bm_cfg, dp_cfg, fu_cfg,
                                  surf_cfg, ts_l_tex, ts_r_tex)

    t_ts, (ts_state2, ts_l) = time_fn(
        stage_ts, (ts_state, ev_x, ev_y, ev_t, ev_p, ev_valid), reps)
    t_bm, matches = time_fn(stage_bm, (ts_l, ev_x, ev_y, ev_t, ev_valid),
                            reps)
    t_solve, est = time_fn(stage_solve, (ts_l, matches, ev_t), reps)

    # --- fusion timed on the real post-solve estimates, with a
    # steady-state history (every slot holds a real frame's estimates,
    # the WORKING-phase worst case) ---
    history0 = empty_history()
    history = est.map(lambda e: e[None].expand((F,) + e.shape).clone())
    t_fuse, _ = time_fn(stage_fuse, (history, 0, est), max(reps, 10))

    # --- full cycle (throughput metric) ---
    out = cycle0(ts_state, history0, 0, ev_x, ev_y, ev_t, ev_p, ev_valid)
    block()
    t_cycle = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for r in range(reps):
            out = cycle0(out[0], out[1], (r + 1) % F, ev_x, ev_y, ev_t,
                         ev_p, ev_valid)
        block()
        t_cycle = min(t_cycle, (time.perf_counter() - t0) / reps)

    counts = roofline_counts(W, H, N, F, bm_cfg, dp_cfg)
    times = {"ts": t_ts, "bm": t_bm, "solve": t_solve, "fuse": t_fuse}
    return {
        "ts_ms": t_ts * 1e3,
        "bm_ms": t_bm * 1e3,
        "solve_ms": t_solve * 1e3,
        "fuse_ms": t_fuse * 1e3,
        "cycle_ms": t_cycle * 1e3,
        "roofline": roofline(counts, times, dev),
    }


# ---------------------------------------------------------------------------
# the closed loop
# ---------------------------------------------------------------------------

def bench_closed_loop(roll=5, dispatch_ticks=(5, 10, 25, 50), duration=3.2,
                      device="cuda"):
    """System-level metric: ticks/s of the closed loop (100 Hz tracking /
    20 Hz mapping, reference README.md:221-226) on a synthetic scene of
    `duration` seconds.

    The device-resident loop (runtime/resident.py) replays one CUDA graph
    a roll of `roll` ticks (tracking, the mapping cycle, the pose table
    and the ref-map publish); a dispatch is `RK // roll` rolls. The sweep
    reports ticks/s per dispatch size, the ATE of each run, and the
    host-driven roll path for comparison. Mapping runs every
    `roll`-th tick in all configurations. The first dispatch of each size
    is the warm-up (on the card it captures the roll's graph: each
    loop's `warmup_ms` / `capture_ms`) and stays out of the timed
    window."""
    dev = resolve_device(device)
    W, H, FX, BASE, TICK = 240, 180, 150.0, 0.1, 0.01
    DUR = duration
    rng = np.random.default_rng(7)
    rig = make_ideal_rig(W, H, FX, FX, W / 2 - 0.5, H / 2 - 0.5, BASE,
                         dtype=F32, device=dev)
    scene = make_scene(rng, num_points=4000, duration=DUR,
                       steps=int(DUR * 100) + 1, motion_scale=0.6,
                       period=0.8)
    ev_l, ev_r = simulate_stereo_events(
        scene, rig.left.params.P.double().cpu().numpy(),
        rig.right.params.P.double().cpu().numpy(), W, H,
        pixel_threshold=0.75, rng=rng)
    ticks = np.arange(TICK, DUR, TICK)
    frames_l = frame_events(ev_l, ticks, 3000)
    frames_r = frame_events(ev_r, ticks, 3000)

    cfg = SystemConfig(
        depth=dr.DepthProblemConfig(max_iteration=10),
        bm=bm.BlockMatchConfig(zncc_threshold=0.25),
        sgm=SGMConfig(num_disparities=48),
        mapping=MappingConfig(process_event_num=800,
                              init_sgm_num_threshold=300,
                              std_var_vis_threshold=0.05,
                              age_vis_threshold=0,
                              denoising=False, regularization=False))
    system = EsvoSystem(rig, cfg, device=dev)

    def pick(f, sl):
        return {k: v[sl] for k, v in f.items() if k != "dropped"}

    def bootstrap():
        system.reset()
        k0 = 0
        while system.status != SystemStatus.WORKING \
                and k0 + roll <= len(ticks):
            system.process_ticks(ticks[k0:k0 + roll],
                                 pick(frames_l, slice(k0, k0 + roll)),
                                 pick(frames_r, slice(k0, k0 + roll)),
                                 do_mapping=True)
            k0 += roll
        if system.status != SystemStatus.WORKING:
            raise RuntimeError(f"closed loop: no WORKING status after "
                               f"{k0} ticks ({system.status.value})")
        return k0

    def ate():
        t_est, poses_est = system.trajectory()
        if not np.isfinite(poses_est).all():
            raise RuntimeError("closed loop: a non-finite pose")
        gt = np.stack([interpolate_gt_pose(scene, t) for t in t_est])
        return float(ate_rmse(t_est, poses_est, t_est, gt))

    by_dispatch, ates = {}, {}
    for RK in dispatch_ticks:
        R = RK // roll
        k0 = bootstrap()
        loop = ResidentLoop(system, ticks_per_roll=roll,
                            rolls_per_dispatch=R)
        loop.start()
        t0 = None
        timed = 0
        while k0 + RK <= len(ticks):
            sl = slice(k0, k0 + RK)
            loop.run(ticks[sl], pick(frames_l, sl), pick(frames_r, sl))
            if t0 is None:      # first dispatch: warm-up + graph capture
                block()
                t0 = time.perf_counter()
            else:
                timed += RK     # later dispatches pipeline freely
            k0 += RK
        if not timed:
            raise ValueError(f"{DUR} s leave no timed {RK}-tick dispatch "
                             f"after the bootstrap and the warm-up")
        block()
        rate = timed / (time.perf_counter() - t0)
        loop.finish()
        if system.status != SystemStatus.WORKING:
            raise RuntimeError(f"closed loop: {RK}-tick dispatches left "
                               f"status {system.status.value}")
        by_dispatch[RK] = rate
        ates[RK] = ate()

    # the host-driven roll path for comparison
    k0 = bootstrap()
    n_host = min(k0 + 50, len(ticks))
    if n_host - k0 <= roll:
        raise ValueError(f"{DUR} s leave no timed host roll")
    t0 = None
    for k in range(k0, n_host, roll):
        if k >= k0 + roll and t0 is None:
            t0 = time.perf_counter()
        sl = slice(k, k + roll)
        system.process_ticks(ticks[sl], pick(frames_l, sl),
                             pick(frames_r, sl), do_mapping=True)
    system.flush()
    block()
    host_rate = (n_host - k0 - roll) / (time.perf_counter() - t0)
    if system.status != SystemStatus.WORKING:
        raise RuntimeError(f"closed loop: the host roll path left status "
                           f"{system.status.value}")

    best = max(by_dispatch.values())
    # ATE varies run-to-run with the stochastic point selection and is
    # dispatch-size independent by construction: report the median
    return {
        "ticks_per_sec": best,
        "vs_design_point_100hz": best / 100.0,
        "ate_m": float(np.median(list(ates.values()))),
        "ate_by_dispatch": ates,
        "n_ticks": int(len(ticks)),
        "by_dispatch_ticks": by_dispatch,
        "host_roll_ticks_per_sec": host_rate,
    }


# ---------------------------------------------------------------------------

def run(device="cuda") -> dict:
    """The whole benchmark at bench.py's widths: the JSON line's dict."""
    dev = resolve_device(device)
    info = device_info(dev)
    rng = np.random.default_rng(0)

    # rpg scale: 240x180, 4096 events/cycle, reference LM trip count
    # (max_iteration=10, cfg/mapping/mapping_rpg.yaml:27)
    rpg = bench_pipeline(
        240, 180, 4096, 8, bm.BlockMatchConfig(),
        dr.DepthProblemConfig(max_iteration=10), reps=20, rng=rng,
        device=dev)
    events_per_sec = 4096 / (rpg["cycle_ms"] * 1e-3)

    # DSEC scale: 640x480, disparity range 151, 8192 events
    # (cfg/mapping/mapping_dsec.yaml: PROCESS_EVENT_NUM=10000, disp 0-150)
    dsec = bench_pipeline(
        640, 480, 8192, 24,
        bm.BlockMatchConfig(min_disparity=0, max_disparity=150),
        dr.DepthProblemConfig(max_iteration=10), reps=10, rng=rng,
        device=dev)

    system = bench_closed_loop(device=dev)
    return {
        "metric": "mapping_pipeline_events_per_sec",
        "value": events_per_sec,
        "unit": "events/s",
        "vs_baseline": events_per_sec / BASELINE_EVENTS_PER_SEC,
        "stages": {"rpg_240x180_n4096": rpg,
                   "dsec_640x480_n8192": dsec},
        "system": system,
        "device": info,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
