"""Drive the PyTorch/CUDA port (esvo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. the card: name, count and power limit;
2. build the seven hand-written CUDA kernels from esvo_tpu_torch/csrc
   (nvcc, sm_90a, one process per source, all at once);
3. each kernel against its plain PyTorch twin on the card, on the same
   inputs, at the rpg (240x180, N=1000) and DSEC (640x480, N=10000)
   shapes, with its time, the twin's, a library call's where one exists,
   and its roofline bound; K1 and K3 also as one pair launch on both
   cameras' inputs; the card's launch floor (a one-element fill_); K4
   (the tracker's 10 LM rounds, 2000 map points) and K5 (regularization
   at the presets' radii 5 and 20, bit for bit in both norms) at the
   same sizes; K6 (block matching's disparity scan at the presets'
   patch, range and smoothing, N events: argmin, cost and validity bit
   for bit, a NaN following torch's argmin, beside the "matmul" volume)
   and K7 (the fusion fold on a grid at each size with 4N candidates, at
   fusion radius 0 and 1 in Tdist and l2, all 11 planes bit for bit);
4. the WORKING mapping cycle (MappingCycle: render -> estimate ->
   rebuild) on synthetic scenes at rpg and DSEC scale, with per-stage
   times, the kernels' launch counts and the error against ground truth;
   the rpg cycle again through the CPU port (the twins) as the reference;
   then the rpg estimates rebuilt by a float64 MappingCycle with
   regularization (K5 takes float32 only: its twin runs, equal to the
   CPU's);
5. the closed loop (EsvoSystem: SGM bootstrap -> tracking <-> mapping) at
   rpg, driven as the JAX package's closed-loop benchmark drives it:
   process_ticks in rolls of 5 from INITIALIZATION to WORKING, then
   flush(); per roll its status, times, map points and tracker stats; at
   the end the ATE against the scene's ground truth, the kernels'
   launches inside the loop, and a profiled tracked roll (launches per
   tick, idle share); the same stream through process_tick one tick at
   a time (the live path: every tick one replay of the tick's graph,
   none eager, one capture a body; its tracked tick's median ms); one
   tracking solve and one SGM bootstrap held against the CPU port on
   the same inputs;
6. the resident loop (ResidentLoop: one CUDA graph a roll) on the same
   scene and seed, framed by EventFrameStream: the host path bootstraps,
   then dispatches of RESIDENT_R rolls; capture time, one graph-replayed
   roll against the same roll run eagerly, ms a tick and ticks/s beside
   the host path's, a profiled dispatch (idle share, kernels a roll,
   K1-K7 launches inside the replays by kernel name, K4 once a tick),
   one replay's device span a tick beside the figures before K4 and K5,
   the ATE and the largest per-tick pose difference from the host path;
7. the tracking solve again while the caller has set float32 matmul
   precision "high": the port's guard keeps it in full float32 (it must
   agree with the CPU port) and the caller's setting holds afterwards;
8. K1 at the event matcher's windows (16x16, 30,000 a surface), checked
   and timed as in 3;
9. the mapper benchmark (MVStereoSystem) on the rpg rig, preset and
   scene in each of its five modes, with ground-truth poses, 30 ticks, a
   mapping cycle every 5: ms a mapping tick, map points, the error
   against the scene, K1-K7 launches and peak memory, and each mode's
   mapping stage replayed by the CPU port on the card's inputs; one
   event-matching cycle at DSEC scale (N = 10000, 25x25 patches);
10. scripts/torch_run_dataset.py on a rosbag of the rpg scene that
   carries its camera_info and ground truth: the closed loop in rolls
   of 5, the same through the resident loop, and --mode mvstereo;
   ticks/s, ATE and map points;
11. the event simulator (io/esim.py) on the room scene at the accuracy
   campaign's sensor: with the noise off, the card against the CPU port
   event for event; with the full sensor, events/s, overflow, the hot
   pixels' rate, ms a substep and peak memory;
12. the backend functions (the loop-closure descriptor, the ICP
   verification, bundle adjustment, the pose graph) on the card against
   the CPU port, also under a caller's TF32 precision, with their times;
13. the closed loop with BackendLoop and PoseGraphLoop attached, on the
   loop-closure e2e test's scene, on the host path and through the
   resident loop: loop closures held against ground truth, BA / ICP /
   pose-graph ms, the run's wall split, ATE raw and optimized;
14. scripts/torch_sim_campaign.py --quick --resident 2 --ba: simulation,
   the closed loop with both backends, and the campaign's scoring
   (loop edges true and none false);
15. the event-axis sharding (parallel/sharding.py), in spawned ranks:
   world 1 on NCCL (every sharded function at rpg and DSEC sizes and
   EsvoSystem(mesh=...) over the closed loop's first 25 ticks, bit for
   bit the unsharded calls on the card; ms a sharded call against the
   unsharded one), then world 2 on gloo over CUDA tensors with both
   ranks on this card (tests/test_parallel.py's tolerances, the ranks'
   replicated outputs bit for bit, the closed loop's ATE under its bar);
   K1-K7 launches summed over the ranks;
16. the depth LM's scan (lm_kernel="xla", zncc, unwindowed) and block
   matching's "matmul" volume at rpg against the CPU port, with ms
   beside K2's path and the "slice" strategy (K6 on the card);
17. scripts/torch_bench.py at bench.py's widths (its rpg and DSEC
   pipelines, the closed loop swept over 5 / 10 / 25 / 50-tick resident
   dispatches beside the host roll path): its JSON line, the dispatch
   sizes gated (WORKING, finite poses, ATE under BENCH_ATE_BAR), the rpg
   and DSEC cycles against the CPU port on the same worlds with a
   profile of each; K1 and K2 checked and timed at its shapes (rpg N =
   4096, DSEC N = 8192 windows);
18. examples/torch_run_synthetic.py (the README's demo) at its defaults
   on the card: WORKING, its ATE bar, K4 launched;
19. the kernel table as one JSON line; the last line is the result.

Any failed check raises, and the script then exits non-zero. Without a
CUDA device it exits non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import re
import struct
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity

from esvo_tpu_torch import convert
from esvo_tpu_torch.backend import loop_closure as lc
from esvo_tpu_torch.backend import pose_graph as pgr
from esvo_tpu_torch.backend.bundle_adjustment import (
    BAConfig, BAProblem, assemble_normal_equations, bundle_adjust)
from esvo_tpu_torch.backend.keyframes import KeyframeGraph, build_ba_problem
from esvo_tpu_torch.geometry.camera import (PinholeParams, StereoRig,
                                            make_camera, make_ideal_rig)
from esvo_tpu_torch.geometry.se3 import (rot_to_quat, se3_exp, se3_inverse,
                                         so3_exp)
from esvo_tpu_torch.io import esim, rosbag
from esvo_tpu_torch.io.events import EventArray, frame_events
from esvo_tpu_torch.io.stream import EventFrameStream
from esvo_tpu_torch.eval.trajectory import ate_rmse, load_tum
from esvo_tpu_torch.io.synthetic import (SyntheticScene, interpolate_gt_pose,
                                         make_scene, simulate_stereo_events)
from esvo_tpu_torch.mapping import block_matching as bm
from esvo_tpu_torch.mapping import depth_refinement as dr
from esvo_tpu_torch.mapping import fusion as fu
from esvo_tpu_torch.mapping import initialization as init
from esvo_tpu_torch.mapping.event_matcher import (
    EventMatcherConfig, match_events_temporal_stats)
from esvo_tpu_torch.mapping.regularization import (regularize,
                                                   regularize_plain)
from esvo_tpu_torch.ops import _build, lm, patches, remap, track
from esvo_tpu_torch.ops import block_match as block_match_op
from esvo_tpu_torch.ops import fuse as fuse_op
from esvo_tpu_torch.ops import regularize as regularize_op
from esvo_tpu_torch.ops.linalg import solve_spd
from esvo_tpu_torch.parallel import sharding as ps
from esvo_tpu_torch.runtime import backend_loop, mvstereo as mv
from esvo_tpu_torch.runtime.backend_loop import BackendLoop
from esvo_tpu_torch.runtime.config import SystemConfig
from esvo_tpu_torch.runtime.pose_graph_loop import PoseGraphLoop
from esvo_tpu_torch.runtime.resident import ResidentLoop, unpack
from esvo_tpu_torch.runtime.system import EsvoSystem, MappingCycle
from esvo_tpu_torch.surface import time_surface as tsf
from esvo_tpu_torch.tracking import registration as reg
from esvo_tpu_torch.utils import profiling as tracer
from esvo_tpu_torch.utils.precision import highest_precision

sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
import torch_bench as tb  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
F32 = torch.float32

# configs/rpg.yaml and configs/dsec.yaml: the sections the mapping cycle
# reads, and for rpg also those of the closed loop (SGM at its defaults,
# the tracker, the tracking node)
RPG = dict(
    surface=dict(decay_sec=0.03, ignore_polarity=True,
                 median_blur_kernel_size=1, mode="backward"),
    bm=dict(patch_size_x=15, patch_size_y=7, min_disparity=1,
            max_disparity=40, step=1, zncc_threshold=0.1, up_down=False,
            smooth_time_surface=False),
    depth=dict(patch_size_x=15, patch_size_y=7, ls_norm="Tdist",
               td_nu=2.1897, td_scale=16.6397, max_iteration=10),
    fusion=dict(fusion_radius=0),
    mapping=dict(inv_depth_min_range=0.2, inv_depth_max_range=2.0,
                 residual_vis_threshold=20.0, std_var_vis_threshold=0.015,
                 age_max_range=10, age_vis_threshold=1,
                 fusion_strategy="CONST_POINTS", max_fusion_frames=40,
                 max_fusion_points=5000, denoising=True, regularization=True,
                 process_event_num=1000, init_sgm_num_threshold=500,
                 mapping_rate_hz=20.0, bm_half_slice_thickness=0.001),
    sgm=dict(num_disparities=48, block_size=11, p1=8.0 * 11 * 11,
             p2=32.0 * 11 * 11, uniqueness_ratio=11.0, init_variance=0.001 ** 2),
    tracker=dict(patch_size_x=1, patch_size_y=1, kernel_size=5,
                 huber_threshold=50.0, max_registration_points=2000,
                 batch_size=300, max_iteration=10, ls_norm="Huber",
                 min_num_events=1000, use_numerical_diff=False),
    tracking=dict(tracking_rate_hz=100.0, ref_history_length=10))
DSEC = dict(
    surface=RPG["surface"],
    bm=dict(RPG["bm"], min_disparity=0, max_disparity=150,
            smooth_time_surface=True),
    depth=dict(RPG["depth"], td_nu=2.182, td_scale=17.277,
               regularization_radius=20, regularization_min_neighbours=32,
               regularization_min_close_neighbours=32),
    fusion=dict(fusion_radius=1),
    mapping=dict(inv_depth_min_range=0.001, inv_depth_max_range=0.25,
                 residual_vis_threshold=30.0, std_var_vis_threshold=1.0,
                 age_max_range=10, age_vis_threshold=1,
                 fusion_strategy="CONST_FRAMES", max_fusion_frames=5,
                 max_fusion_points=20000, denoising=False,
                 regularization=True, process_event_num=10000))

# Two stereo rigs with plumb_bob distortion and a rectification rotation
# per camera, so the rectification maps (kernel K3's input) are far from
# the identity: (W, H, K, D, per-camera rectification angles about y and
# x, rectified focal length, baseline).
RIGS = {
    "rpg": (240, 180, (201.5, 200.8, 119.3, 90.4),
            (-0.28, 0.07, 1.5e-3, -8e-4), ((0.012, -0.008), (-0.010, -0.008)),
            195.0, 0.1),
    "dsec": (640, 480, (560.0, 559.0, 318.6, 241.2),
             (-0.09, 0.09, 1e-4, -2e-4), ((0.008, 0.004), (-0.006, 0.004)),
             550.0, 0.6),
}

# Synthetic scenes: edge points, their scale (metres; the DSEC scene is
# pushed out to 5-12 m, inside that preset's inverse-depth range), event
# threshold (px), sync ticks, frame capacity. The motion has a 1 s period
# and is simulated in 10 steps per tick, so every tick carries thousands
# of events (enough to pass the rpg preset's denoiser and fill N). The
# MappingCycle runs take the first `cycle_ticks`; the rpg closed loop
# takes the first LOOP_ROLLS rolls and two more for its profile.
SCENES = {"rpg": dict(points=6000, scale=1.0, threshold=0.5, ticks=100,
                      cycle_ticks=20, cap=8000, seed=1),
          "dsec": dict(points=12000, scale=4.0, threshold=1.0, ticks=15,
                       cycle_ticks=15, cap=40000, seed=2)}
TICK = 0.01            # 100 Hz surfaces
MAP_EVERY = 5          # 20 Hz mapping
ROLL = 5               # ticks a process_ticks roll (bench.py's closed loop)
LOOP_ROLLS = 18
RESIDENT_R = 2         # rolls a resident dispatch (scripts/sim_campaign.py)
# ATE bar of the rpg closed loop (m), calibrated on the CPU port on the
# same stream by scripts/torch_closed_loop_ate.py (PERF.md): its 90 ticks
# score 0.038-0.058 m over twelve point-selection seeds, a pose held at
# the start 0.092 m. The loop is chaotic at the centimetre level, so the
# bar leaves room above the seeds' spread and stays below the static
# pose's score.
CLOSED_LOOP_ATE_BAR = 0.07
# the resident loop's figures before K4 and K5 replaced the tracker's and
# the regularizer's eager ops (PERF.md section 5, measured by this script
# on an H100 80GB HBM3 at 700 W): kernels a roll of a profiled dispatch,
# one replay's device span a tick (ms), ticks/s
RESIDENT_BEFORE_K4_K5 = dict(kernels_per_roll=38450, replay_ms_per_tick=10.79,
                             ticks_per_s=[74.2, 110.0])
# ATE bar of scripts/torch_bench.py's closed loop (m; its own 3.2-s scene
# and config), calibrated on the CPU port by
# `scripts/torch_closed_loop_ate.py --bench`: 0.044-0.122 m over eight
# point-selection seeds and the four dispatch sizes (the JAX package's
# BENCH_r05.json: 0.053-0.130). A pose held at the start scores 0.054 m
# on this scene, so the bar gates a lost track, not accuracy.
BENCH_ATE_BAR = 0.15


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time per call of fn between CUDA events, after warm-up: the
    caller's view, host launch gaps included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(prof) -> float:
    """Device time (us) of every kernel and copy in a profile."""
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
    return total


def timed(fn, iters: int) -> dict:
    """ms: device time per call, from the profiler's kernel records (the
    card's own clock, without host gaps); call_ms: per call between CUDA
    events. Where the profiler records no device time, ms is call_ms and
    `timing` says so."""
    call = cuda_ms(fn, iters)
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = _device_us(prof) / 1e3 / iters
    if dev > 0:
        return dict(ms=dev, call_ms=call, timing="profiler")
    return dict(ms=call, call_ms=call, timing="cuda-events")


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time on the card (ms) and what sets it."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# rigs and scenes
# ---------------------------------------------------------------------------

def _rot(ay: float, ax: float) -> np.ndarray:
    cy, sy, cx, sx = math.cos(ay), math.sin(ay), math.cos(ax), math.sin(ax)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return Ry @ Rx


def make_rig(name: str, device, dtype=F32) -> StereoRig:
    W, H, (fx, fy, cx, cy), D, angles, f, b = RIGS[name]
    kw = dict(dtype=dtype, device=device)
    K = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], **kw)
    cams = []
    for (ay, ax), tx in zip(angles, (0.0, -f * b)):
        P = torch.tensor([[f, 0, W / 2, tx], [0, f, H / 2, 0], [0, 0, 1, 0]],
                         **kw)
        cams.append(make_camera(PinholeParams(
            K=K, D=torch.tensor(D, **kw), R=torch.tensor(_rot(ay, ax), **kw),
            P=P, width=W, height=H, model="plumb_bob")))
    T = torch.eye(4, **kw)
    T[0, 3] = -b
    return StereoRig(left=cams[0], right=cams[1], T_right_left=T,
                     baseline=torch.tensor(b, **kw))


def _to_raw(ev: EventArray, inv_map: np.ndarray, mask: np.ndarray):
    """Events simulated at rectified pixels -> the raw sensor pixels the
    rectification map samples there (drops pixels off the sensor)."""
    H, W = mask.shape
    raw = inv_map[ev.y, ev.x]
    xr = np.floor(raw[:, 0]).astype(np.int32)
    yr = np.floor(raw[:, 1]).astype(np.int32)
    keep = mask[ev.y, ev.x] & (xr >= 0) & (xr < W) & (yr >= 0) & (yr < H)
    return EventArray(t=ev.t[keep], x=xr[keep], y=yr[keep], p=ev.p[keep])


def make_stream(name: str, rig: StereoRig, n_ticks: int | None = None):
    """Synthetic scene, sync ticks (SCENES' count unless n_ticks is
    given), raw event frames for both cameras."""
    scene, ticks, evs = make_events(name, rig, n_ticks)
    return scene, ticks, [frame_events(e, ticks, SCENES[name]["cap"])
                          for e in evs]


def make_events(name: str, rig: StereoRig, n_ticks: int | None = None):
    """Synthetic scene, sync ticks and both cameras' raw event streams."""
    s = SCENES[name]
    W, H = rig.left.width, rig.left.height
    rng = np.random.default_rng(s["seed"])
    n_ticks = n_ticks or s["ticks"]
    duration = (n_ticks + 1) * TICK
    scene = make_scene(rng, num_points=s["points"], duration=duration,
                       steps=10 * (n_ticks + 1) + 1, motion_scale=1.0,
                       period=1.0)
    poses = scene.traj_poses.copy()
    poses[:, :3, 3] *= s["scale"]     # a uniform scale keeps projections
    scene = SyntheticScene(points=scene.points * s["scale"],
                           traj_times=scene.traj_times, traj_poses=poses)
    cams = (rig.left, rig.right)
    evs = simulate_stereo_events(
        scene, *[c.params.P.double().cpu().numpy() for c in cams], W, H,
        pixel_threshold=s["threshold"], rng=rng)
    evs = [_to_raw(e, c.inv_map.cpu().numpy(), c.mask.cpu().numpy())
           for e, c in zip(evs, cams)]
    return scene, np.arange(1, n_ticks + 1) * TICK, evs


# ---------------------------------------------------------------------------
# kernels against their twins
# ---------------------------------------------------------------------------

def _times(err, kernel, plain, library, iters, bound_ms, bound_by) -> dict:
    k = timed(kernel, iters)
    p = timed(plain, max(1, iters // 10))
    lib = timed(library, iters) if library is not None else None
    return dict(max_abs_err=err, kernel_ms=k["ms"], plain_ms=p["ms"],
                library_ms=None if lib is None else lib["ms"],
                bound_ms=bound_ms, bound_by=bound_by, call_ms=k["call_ms"],
                plain_call_ms=p["call_ms"],
                library_call_ms=None if lib is None else lib["call_ms"],
                timing=k["timing"])


def check_remap(rig: StereoRig, iters: int = 200) -> dict:
    """K3 on the left camera as one launch, and on both cameras (two
    images through the left and right maps) as one pair launch; each
    bit-exact with its twin, timed beside its bound and grid_sample."""
    cam = rig.left
    H, W = cam.height, cam.width
    gen = torch.Generator(device="cuda").manual_seed(3)
    img, img_r = (torch.randint(0, 256, (H, W), generator=gen,
                                device="cuda").to(F32) for _ in range(2))
    m = cam.inv_map.contiguous()
    m_r = rig.right.inv_map.contiguous()
    got = remap.remap(img, m)
    pair = remap.remap_pair(img, m, img_r, m_r)
    want = (remap.remap_plain(img, m, 0.0), remap.remap_plain(img_r, m_r, 0.0))
    err = float((got - want[0]).abs().max())
    err_pair = max(float((a - b).abs().max()) for a, b in zip(pair, want))
    if not (torch.equal(got, want[0])
            and all(torch.equal(a, b) for a, b in zip(pair, want))):
        raise AssertionError(f"K3 remap is not bit-exact: single {err}, "
                             f"pair {err_pair}")
    grids = [torch.stack([2 * mm[..., 0] / (W - 1) - 1,
                          2 * mm[..., 1] / (H - 1) - 1], -1)[None]
             for mm in (m, m_r)]
    lib = lambda im, g: F.grid_sample(im[None, None], g, mode="bilinear",
                                      padding_mode="zeros",
                                      align_corners=True)
    # per pixel: map 8 B in, image 4 B in, 4 B out; 15 flops (2 floors'
    # fractions, 2 complements, 4 weights, 4 products, 3 sums)
    b, by = bound(H * W * (4 + 8 + 4), H * W * 15)
    res = _times(err, lambda: remap.remap(img, m),
                 lambda: remap.remap_plain(img, m, 0.0),
                 lambda: lib(img, grids[0]), iters, b, by)
    b2, by2 = bound(2 * H * W * (4 + 8 + 4), 2 * H * W * 15)
    res["pair"] = _times(
        err_pair, lambda: remap.remap_pair(img, m, img_r, m_r),
        lambda: (remap.remap_plain(img, m, 0.0),
                 remap.remap_plain(img_r, m_r, 0.0)),
        lambda: (lib(img, grids[0]), lib(img_r, grids[1])), iters, b2, by2)
    return res


def check_patches(rig: StereoRig, n: int, iters: int = 200, h: int = 24,
                  w: int = 32) -> dict:
    """K1 on one surface as one launch, and on two surfaces with two start
    sets as one pair launch; each bit-exact with its twin, timed beside
    its bound and the advanced-index gather. (h, w): the window, the
    depth LM's 24x32 unless given."""
    H, W = rig.left.height, rig.left.width
    gen = torch.Generator(device="cuda").manual_seed(4)
    img = torch.rand((H, W), generator=gen, device="cuda") * 255
    uy = torch.randint(-4, H - h + 4, (n,), generator=gen, device="cuda",
                       dtype=torch.int32)          # some starts clamp
    ux = torch.randint(-4, W - w + 4, (n,), generator=gen, device="cuda",
                       dtype=torch.int32)
    img_r = torch.rand((H, W), generator=gen, device="cuda") * 255
    uy_r = torch.randint(-4, H - h + 4, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    ux_r = torch.randint(-4, W - w + 4, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    got = patches.slice_patches(img, uy, ux, h, w)
    want = patches.slice_patches_plain(img, uy, ux, h, w)
    pair = patches.slice_patches_pair(img, uy, ux, img_r, uy_r, ux_r, h, w)
    want_r = patches.slice_patches_plain(img_r, uy_r, ux_r, h, w)
    if not (torch.equal(got, want) and torch.equal(pair[0], want)
            and torch.equal(pair[1], want_r)):
        raise AssertionError("K1 slice_patches is not bit-exact")

    def index(y, x):
        rr = (torch.clamp(y.long(), 0, H - h)[:, None, None]
              + torch.arange(h, device="cuda")[None, :, None])
        cc = (torch.clamp(x.long(), 0, W - w)[:, None, None]
              + torch.arange(w, device="cuda")[None, None, :])
        return rr, cc

    (rr, cc), (rr_r, cc_r) = index(uy, ux), index(uy_r, ux_r)
    b, by = bound(H * W * 4 + n * 8 + n * h * w * 4, 0)
    res = _times(float((got - want).abs().max()),
                 lambda: patches.slice_patches(img, uy, ux, h, w),
                 lambda: patches.slice_patches_plain(img, uy, ux, h, w),
                 lambda: img[rr, cc], iters, b, by)
    b2, by2 = bound(2 * (H * W * 4 + n * 8 + n * h * w * 4), 0)
    res["pair"] = _times(
        max(float((a - b).abs().max()) for a, b in zip(pair, (want, want_r))),
        lambda: patches.slice_patches_pair(img, uy, ux, img_r, uy_r, ux_r,
                                           h, w),
        lambda: (patches.slice_patches_plain(img, uy, ux, h, w),
                 patches.slice_patches_plain(img_r, uy_r, ux_r, h, w)),
        lambda: (img[rr, cc], img_r[rr_r, cc_r]), iters, b2, by2)
    res["plan"] = k1_plan(h, w, n)
    return res


def k1_plan(h: int, w: int, n: int) -> dict:
    """K1's instantiation and launch for n windows (single) and 2n
    (pair): registers, local bytes and spills, blocks an SM, grids."""
    info = patches.kernel_info(h, w)
    rep = ptxas_report(_build.BUILD_LOG.get("patches.cu", "")).get(
        info["name"], {})
    grid = lambda k: patches.patches_launch_plan(
        k, info["sms"], info["blocks_per_sm"], info["warps"])
    return dict(instantiation=info["name"], band_rows=info["band_rows"],
                vec=info["vec"],
                registers=info["registers"], local_bytes=info["local_bytes"],
                spill_stores=rep.get("spill_stores"),
                spill_loads=rep.get("spill_loads"),
                blocks_per_sm=info["blocks_per_sm"],
                warps_per_sm=info["blocks_per_sm"] * info["warps"],
                sms=info["sms"], grid=grid(n), pair_grid=grid(2 * n))


def launch_floor(iters: int = 200) -> dict:
    """The card's launch floor: the device time of a one-element fill_."""
    one = torch.empty(1, device="cuda")
    t = timed(lambda: one.fill_(1.0), iters)
    return dict(launch_floor_ms=t["ms"], call_ms=t["call_ms"],
                of="torch.Tensor.fill_ on one float32 element",
                timing=t["timing"])


def lm_world(rig: StereoRig, cfg: SystemConfig, n: int, disp: int,
             seed: int):
    """The depth solve's kernel inputs on a textured stereo pair whose
    right surface is the left one shifted by `disp` pixels plus noise of
    half an 8-bit level (so no residual is exactly zero)."""
    rng = np.random.default_rng(seed)
    H, W = rig.left.height, rig.left.width
    f = float(rig.left.params.P[0, 0])
    base = rng.uniform(0, 255, (H, W + 2 * disp + 64))
    k = np.ones(5) / 5
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    ts_l = base[:, 32:32 + W]
    ts_r = base[:, 32 + disp:32 + disp + W] + rng.uniform(-0.5, 0.5, (H, W))
    coords = np.stack([rng.uniform(30 + disp, W - 30, n),
                       rng.uniform(20, H - 20, n)], 1)
    d_true = disp / (f * float(rig.baseline))
    d_init = d_true * rng.uniform(0.85, 1.15, n)
    T_lv = se3_exp(torch.tensor(rng.normal(0, 2e-3, (n, 6)), dtype=F32))
    t = lambda a: torch.tensor(a, dtype=F32, device="cuda")
    return dr.window_problem(t(coords), T_lv.cuda(), t(d_init), t(ts_l),
                             t(ts_r), rig, cfg.depth)


def check_lm(rig: StereoRig, cfg: SystemConfig, n: int, disp: int,
             iters: int = 20) -> dict:
    """K2 against its twin, launched twice (the two launches must agree
    bit for bit), with its launch plan and the work the data asked for."""
    args, kw = lm_world(rig, cfg, n, disp, seed=5)
    work = torch.zeros(3, dtype=torch.int64, device="cuda")
    got = lm.lm_solve(*args, **kw, work=work)
    work2 = torch.zeros(3, dtype=torch.int64, device="cuda")
    again = lm.lm_solve(*args, **kw, work=work2)
    if not (all(torch.equal(x, y) for x, y in zip(got, again))
            and torch.equal(work, work2)):
        raise AssertionError("K2: two launches on the same inputs differ")
    want = lm.lm_solve_plain(*args, **kw)
    d_k, c_k, j_k = (a.cpu().numpy() for a in got)
    d_t, c_t, j_t = (a.cpu().numpy() for a in want)
    # The accept test (cost_try < cost) races at float32 rounding: the
    # kernel's FMAs and warp-shuffle sums round otherwise than the twin's
    # ops, and a few events take another accept/reject path (tests/
    # test_torch_lm.py measures the same between the JAX package's own two
    # paths). So each tolerance must hold on at least 98% of the events.
    both = (d_k > 1e-3) & (d_t > 1e-3)
    agree = ((d_k > 1e-3) == (d_t > 1e-3)).mean()
    close = both & np.isclose(d_k, d_t, rtol=2e-4, atol=2e-5)
    cost_ok = close & np.isclose(c_k, c_t, rtol=2e-2, atol=1e-3)
    jtj_ok = close & np.isclose(j_k, j_t, rtol=2e-2, atol=0)
    shares = dict(validity=agree, inv_depth=close.sum() / both.sum(),
                  cost=cost_ok.sum() / both.sum(),
                  jtj=jtj_ok.sum() / both.sum())
    if not (agree > 0.98 and min(shares.values()) >= 0.98):
        raise AssertionError(f"K2 differs from its twin: {shares}")
    evals, in_bounds, trips = (int(v) for v in work.cpu())
    P = kw["wy"] * kw["wx"]
    # flops per patch pixel, counted from lm.cu: two bilinear samples with
    # their d-derivatives (36) per evaluation; the Tdist weights and cost
    # (11) per in-bounds evaluation; 7 per scale fixed-point trip; g and h
    # (4) per LM step; J^T J (2) once
    flops = P * (36 * evals + 11 * in_bounds + 7 * trips + 4 * (evals - n)
                 + 2 * n)
    Wy, Wx = kw["Wy"], kw["Wx"]
    nbytes = 2 * n * Wy * Wx * 4 + n * (3 + 4 + 12) * 4 + 33 * 4 + 3 * n * 4
    b, by = bound(nbytes, flops)
    res = _times(float(np.abs(d_k[both] - d_t[both]).max()),
                 lambda: lm.lm_solve(*args, **kw),
                 lambda: lm.lm_solve_plain(*args, **kw), None, iters, b, by)
    res.update(within_tol=shares, evaluations=evals, in_bounds=in_bounds,
               scale_trips=trips, flops=flops, bytes=nbytes,
               plan=lm_plan(kw, n))
    return res


def ptxas_report(log: str) -> dict[str, dict]:
    """Registers, stack and spill bytes per kernel from nvcc -Xptxas -v."""
    fns, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            m = re.search(r"lm_kernelILi(\d+)ELb([01])E", cur)
            if m:   # demangle K2's instantiations as lm.kernel_info names
                cur = (f"lm_kernel<{m[1]}, "
                       f"{'true' if m[2] == '1' else 'false'}>")
            m = re.search(r"slice_patches_kernelILi(\d+)ELi(\d+)E", cur)
            if m:   # K1's, as patches.kernel_info names them
                cur = f"slice_patches_kernel<{m[1]}, {m[2]}>"
            m = re.search(r"regularize_kernelILb([01])E", cur)
            if m:   # K5's, as regularize_op.kernel_info names them
                cur = (f"regularize_kernel<"
                       f"{'true' if m[1] == '1' else 'false'}>")
            m = re.search(r"block_match_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                          cur)
            if m:   # K6's, as block_match_op.launch_plan names them
                cur = f"block_match_kernel<{m[1]}, {m[2]}, {m[3]}>"
            if "track_solve_kernel" in cur:    # K4's one kernel
                cur = "track_solve_kernel"
            fns[cur] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            fns[cur].update(stack_bytes=int(m[1]), spill_stores=int(m[2]),
                            spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            fns[cur]["registers"] = int(m[1])
    return fns


def lm_plan(kw: dict, n: int) -> dict:
    """K2's instantiation and launch for this shape: registers and local
    bytes (CUDA runtime), spills (ptxas), blocks an SM holds, grid,
    shared memory a block."""
    info = lm.kernel_info(lm.patch_kpl(kw["wy"], kw["wx"]),
                          kw["ls_norm"] == "Tdist", kw["Wy"], kw["Wx"])
    plan = lm.lm_launch_plan(kw["wy"], kw["wx"], kw["Wy"], kw["Wx"], n,
                             info["sms"], info["blocks_per_sm"],
                             info["warps"])
    rep = ptxas_report(_build.BUILD_LOG.get("lm.cu", "")).get(info["name"],
                                                               {})
    return dict(instantiation=info["name"], registers=info["registers"],
                local_bytes=info["local_bytes"],
                spill_stores=rep.get("spill_stores"),
                spill_loads=rep.get("spill_loads"),
                blocks_per_sm=info["blocks_per_sm"],
                warps_per_sm=info["blocks_per_sm"] * info["warps"],
                sms=info["sms"], grid=plan["grid"],
                smem_bytes_per_block=info["smem_bytes"], buffering="single")


def track_world(rig: StereoRig, m: int, seed: int, device="cuda",
                n_valid: int | None = None):
    """A tracking problem at the rig's size: m map points at 1.5-4 m (a
    tenth of them invalid; with n_valid, the first n_valid valid and the
    rest not, as a map of n_valid points in m slots), an edge surface
    (255 at the points' projections from a true pose a small motion
    away, a Gaussian fall-off of 2.5 px) through the tracker's blur and
    Sobel, and the identity as the guess. Returns (problem, camera,
    config)."""
    rng = np.random.default_rng(seed)
    cam = rig.left
    H, W = cam.height, cam.width
    P = cam.params.P.double().cpu().numpy()
    f = P[0, 0]
    x_half, y_half = 0.45 * W / f, 0.45 * H / f
    z = rng.uniform(1.5, 4.0, m)
    pts = np.stack([rng.uniform(-x_half, x_half, m) * z,
                    rng.uniform(-y_half, y_half, m) * z, z], 1)
    T_true = np.eye(4)
    T_true[:3, :3] = so3_exp(torch.tensor([0.001, -0.0015, 0.001],
                                          dtype=torch.float64)).numpy()
    T_true[:3, 3] = [0.008, -0.006, 0.004]
    Tinv = np.linalg.inv(T_true)
    p = pts @ Tinv[:3, :3].T + Tinv[:3, 3]
    h = p @ P[:, :3].T + P[:, 3]
    uv = h[:, :2] / h[:, 2:3]
    d2 = np.full((H, W), np.inf)
    rad = 8
    for u, v in uv:
        x0, y0 = int(np.floor(u)) - rad, int(np.floor(v)) - rad
        xs = np.arange(max(x0, 0), min(x0 + 2 * rad + 1, W))
        ys = np.arange(max(y0, 0), min(y0 + 2 * rad + 1, H))
        if xs.size and ys.size:
            sub = d2[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1]
            np.minimum(sub, (xs[None] - u) ** 2 + (ys[:, None] - v) ** 2,
                       out=sub)
    ts = torch.tensor(255.0 * np.exp(-d2 / (2 * 2.5 ** 2)), dtype=F32,
                      device=device)
    valid = torch.tensor(rng.random(m) > 0.1, device=device)
    if n_valid is not None:
        valid = torch.arange(m, device=device) < n_valid
    cfg = reg.RegProblemConfig(**RPG["tracker"])
    eye = torch.eye(4, dtype=F32, device=device)
    prob = reg.make_problem(eye, eye, torch.tensor(pts, dtype=F32,
                                                   device=device),
                            valid, ts, cfg)
    return prob, cam, cfg


def _pose_diff(Ta: torch.Tensor, Tb: torch.Tensor) -> tuple[float, float]:
    a, b = Ta.double().cpu().numpy(), Tb.double().cpu().numpy()
    return (float(np.linalg.norm(a[:3, 3] - b[:3, 3])),
            pose_angle(a[:3, :3], b[:3, :3]))


def _track_against_twin(rig: StereoRig, m: int, n_valid, device):
    """K4 and solve_plain on one problem: two launches bit for bit, the
    final pose within 1e-4 m and 1e-4 rad (tests/test_torch_tracking.py's
    tolerance; the rounds' accept tests may fall otherwise on near-ties,
    so the rounds whose rms differs by more than 1e-3 relative are
    counted, not gated). Returns (problem, camera, config, fields)."""
    prob, cam, cfg = track_world(rig, m, seed=7, device=device,
                                 n_valid=n_valid)
    got = reg.solve(prob, cam, cfg)
    again = reg.solve(prob, cam, cfg)
    if not all(torch.equal(a, b) for a, b in zip(
            (got[0].R, got[0].t, got[1], got[2]),
            (again[0].R, again[0].t, again[1], again[2]))):
        raise AssertionError("K4: two launches on the same inputs differ")
    want = reg.solve_plain(prob, cam, cfg)
    t_diff, R_diff = _pose_diff(got[1], want[1])
    rms_k, rms_p = got[2].cpu().numpy(), want[2].cpu().numpy()
    if not (t_diff < 1e-4 and R_diff < 1e-4):
        raise AssertionError(f"K4 differs from its twin ({m} points, "
                             f"{n_valid} valid): {t_diff} m, {R_diff} rad, "
                             f"rms {rms_k} vs {rms_p}")
    fields = dict(t_diff_m=t_diff, R_diff_rad=R_diff,
                  rounds_rms_differ=int((np.abs(rms_k - rms_p)
                                         > 1e-3 * np.abs(rms_p)).sum()),
                  rms_kernel=rms_k.tolist(), rms_twin=rms_p.tolist())
    return prob, cam, cfg, fields


def _track_args(prob, cam, cfg, **over) -> tuple[list, dict]:
    args = [a.contiguous() for a in (prob.R, prob.t, prob.T_world_ref,
                                     prob.points, prob.point_valid,
                                     prob.ts_negative, prob.grad_u,
                                     prob.grad_v, cam.params.P, cam.mask)]
    kw = dict(batch_size=cfg.batch_size, max_iteration=cfg.max_iteration,
              huber=cfg.ls_norm == "Huber",
              huber_threshold=cfg.huber_threshold,
              lm_damping=cfg.lm_damping)
    kw.update(over)
    return args, kw


def _track_work(prob, batch_size: int, K: int) -> tuple[int, int, int]:
    """(bytes, flops, rounds whose batch holds a valid point) of one K4
    launch on this problem: each point of the visited non-empty batches
    once (12 B + its valid byte), the valid byte of the other visited
    points, and per point and non-empty round the taps the
    three passes need (4 of the negative surface for the cost, 4 of each
    gradient for the Jacobian, 4 for the trial cost: 16 floats) and 3
    mask bytes; the outputs. flops per point and non-empty round,
    counted from track.cu: the two residuals (~50 each), the Jacobian
    (~92), the 33 running sums (~58); per non-empty round the serial 6x6
    algebra (~400). An empty round reads and computes nothing."""
    M = prob.points.shape[0]
    B = min(batch_size, M)
    nb = max(M // batch_size, 1)
    starts = [min((it % nb) * batch_size, M - B) for it in range(K)]
    valid = prob.point_valid.cpu().numpy()
    full = [s for s in starts if valid[s:s + B].any()]
    used = {i for s in set(full) for i in range(s, s + B)}
    seen = {i for s in set(starts) for i in range(s, s + B)}
    nbytes = len(used) * 13 + len(seen - used) + len(full) * B * (16 * 4 + 3) \
        + (28 + K) * 4
    return nbytes, len(full) * (B * 250 + 400), len(full)


def check_track(rig: StereoRig, m: int = 2000, iters: int = 200,
                device="cuda", partial_valid: int = 600) -> dict:
    """K4 (one launch: the tracker's 10 LM rounds) against its twin
    solve_plain on the card (_track_against_twin) on two problems: m map
    points (a tenth invalid), and a map of `partial_valid` points in the
    same m slots (at 600 of 2000, 6 of the 10 rounds find no valid
    point), each timed. The split of the full problem's time: K4 at
    batch 32 against 300, and at 1 round against 10. Timed through
    ops/track.py's wrapper on contiguous inputs, so the time is K4's."""
    prob, cam, cfg, fields = _track_against_twin(rig, m, None, device)
    args, kw = _track_args(prob, cam, cfg)
    K = cfg.max_iteration
    nbytes, flops, _ = _track_work(prob, cfg.batch_size, K)
    b, by = bound(nbytes, flops)
    res = _times(max(fields["t_diff_m"], fields["R_diff_rad"]),
                 lambda: track.track_solve(*args, **kw),
                 lambda: reg.solve_plain(prob, cam, cfg), None, iters, b, by)
    res.update(fields, rounds=K, points=m, batch=min(cfg.batch_size, m),
               bytes=nbytes, flops=flops)
    split = {}
    for name, over in (("b300_k10", {}), ("b32_k10", dict(batch_size=32)),
                       ("b300_k1", dict(max_iteration=1))):
        a, k = _track_args(prob, cam, cfg, **over)
        split[name] = timed(lambda: track.track_solve(*a, **k), iters)["ms"]
    res["split_ms"] = split

    pprob, pcam, pcfg, pfields = _track_against_twin(rig, m, partial_valid,
                                                     device)
    a, k = _track_args(pprob, pcam, pcfg)
    pbytes, pflops, full_rounds = _track_work(pprob, pcfg.batch_size, K)
    pb, pby = bound(pbytes, pflops)
    t = timed(lambda: track.track_solve(*a, **k), iters)
    res["partial_map"] = dict(
        pfields, valid_points=partial_valid, empty_rounds=K - full_rounds,
        kernel_ms=t["ms"], call_ms=t["call_ms"], bound_ms=pb, bound_by=pby,
        bytes=pbytes, flops=pflops)
    return res


def k4_plan() -> dict:
    """K4's registers, local bytes and shared memory (CUDA runtime),
    spills (ptxas), and its one block."""
    info = track.kernel_info()
    rep = ptxas_report(_build.BUILD_LOG.get("track.cu", "")).get(
        info["name"], {})
    return dict(info, spill_stores=rep.get("spill_stores"),
                spill_loads=rep.get("spill_loads"), blocks=1)


REG_PATTERNS = ("random", "empty", "full", "corners", "edges")


def regularize_world(H: int, W: int, seed: int, nu_inf_share: float = 0.2,
                     device="cuda", pattern: str = "random") -> fu.DepthGrid:
    """A fused depth grid at (H, W): a slanted inverse-depth plane with
    noise, per-cell variances, Student-t scales and nu (a share of them
    inf). Occupancy by `pattern`: "random", about a sixth of the cells
    (denser at the bottom); "empty"; "full"; "corners", the four corner
    cells; "edges", bands along a curve, 80% filled, as an edge map, with
    a twentieth of the unoccupied cells NaN and a twentieth -inf, and one
    occupied cell in 2,000 +inf."""
    rng = np.random.default_rng(seed)
    gy, gx = np.mgrid[0:H, 0:W]
    noise = (0.002 + 0.02 * gx / W) * rng.standard_normal((H, W))
    occ = rng.random((H, W)) < 0.02 + 0.3 * (gy / H) ** 2
    extra = np.random.default_rng(seed + 1)
    if pattern == "empty":
        occ = np.zeros((H, W), bool)
    elif pattern == "full":
        occ = np.ones((H, W), bool)
    elif pattern == "corners":
        occ = np.zeros((H, W), bool)
        occ[[0, 0, -1, -1], [0, -1, 0, -1]] = True
    elif pattern == "edges":
        occ = (np.abs(np.sin(gx / 7.0) + np.cos(gy / 9.0)) < 0.25) \
            & (extra.random((H, W)) < 0.8)
    elif pattern != "random":
        raise ValueError(f"unknown occupancy pattern {pattern!r}")
    inv = np.where(occ, 0.3 + 0.2 * gx / W + 0.1 * gy / H + noise, -1.0)
    if pattern == "edges":
        pick = extra.random((H, W))
        inv[~occ & (pick < 0.05)] = np.nan
        inv[~occ & (pick > 0.95)] = -np.inf
        inv[occ & (extra.random((H, W)) < 0.0005)] = np.inf
    var = (0.004 + 0.01 * rng.random((H, W))) ** 2
    nu = 2.0 + 4.0 * rng.random((H, W))
    nu[rng.random((H, W)) < nu_inf_share] = np.inf
    t = lambda a: torch.tensor(a, dtype=F32, device=device)
    grid = fu.empty_grid(H, W, F32, device)
    return grid.replace(inv_depth=t(inv), variance=t(var),
                        scale2=t(var * (0.5 + rng.random((H, W)))), nu=t(nu))


def fuse_world(H: int, W: int, m: int, seed: int, nu_inf_share: float = 0.2,
               device="cuda"):
    """A fused grid and m candidates for the fold (kernel K7): the grid
    as regularize_world's (2-32% occupied, denser at the bottom, a share
    of nu infinite) with residuals, ages, sub-pixel coordinates and
    points; the candidates' anchors crowd every 16th row and 3rd column,
    so some pixels get more than K, and each candidate's inverse depth is set
    against its anchor cell to hit every rule: a compatible one (fuse),
    one 6 sigma nearer (replace, where its variance and residual are also
    lower) or 6 sigma farther (occluded); on an empty cell, insert. A
    tenth are invalid and a few have invD <= 0. Returns (grid,
    candidates)."""
    rng = np.random.default_rng(seed)
    grid = regularize_world(H, W, seed, nu_inf_share, device)
    t = lambda a, dt=F32: torch.tensor(a, dtype=dt, device=device)
    gy, gx = np.mgrid[0:H, 0:W]
    occ = grid.occupied.cpu().numpy()
    x = np.stack([gx + 0.5, gy + 0.5], -1)
    x[occ] += rng.uniform(-0.4, 0.4, (int(occ.sum()), 2))
    grid = grid.replace(
        residual=t(rng.uniform(0, 30, (H, W))),
        age=t(rng.integers(1, 6, (H, W)), torch.int32), x=t(x),
        p_cam=t(rng.normal(0, 2, (H, W, 3))))
    g_inv = grid.inv_depth.cpu().numpy().astype(np.float64)
    g_var = grid.variance.cpu().numpy().astype(np.float64)
    row = rng.integers(0, max(H // 16, 1), m) * 16 % H
    col = rng.integers(0, max(W // 3, 1), m) * 3 % W
    xc = np.stack([col + rng.uniform(0, 1, m), row + rng.uniform(0, 1, m)],
                  1)
    cell_inv, cell_var = g_inv[row, col], g_var[row, col]
    kind = rng.integers(0, 3, m)          # compatible, nearer, farther
    sigma = np.sqrt(cell_var)
    inv = np.where(cell_inv > 0, cell_inv + np.choose(
        kind, [rng.normal(0, 0.5, m) * sigma, 6 * sigma, -6 * sigma]),
        rng.uniform(0.2, 0.8, m))
    inv[rng.random(m) < 0.02] = -0.1
    var = np.where(rng.random(m) < 0.5, 0.5, 2.0) * np.where(
        cell_inv > 0, cell_var, (0.004 + 0.01 * rng.random(m)) ** 2)
    nu = 2.0 + 4.0 * rng.random(m)
    nu[rng.random(m) < nu_inf_share] = np.inf
    cand = fu.Candidates(
        inv_depth=t(inv), variance=t(var),
        scale2=t(var * (0.5 + rng.random(m))), nu=t(nu),
        residual=t(rng.uniform(0, 30, m)),
        age=t(rng.integers(0, 3, m), torch.int32), x=t(xc),
        p_cam=t(rng.normal(0, 2, (m, 3))),
        valid=torch.tensor(rng.random(m) > 0.1, device=device))
    return grid, cand


def close_pairs(grid: fu.DepthGrid, r: int) -> int:
    """(valid centre, close neighbour) pairs over the (2r+1)^2 windows:
    the pairs the Tdist fold updates on (regularize_plain's `close`)."""
    H, W = grid.inv_depth.shape
    valid, invD = grid.occupied, grid.inv_depth
    std2 = 2.0 * torch.sqrt(torch.clamp(grid.variance, min=0.0))
    pv = F.pad(valid, (r, r, r, r), value=False)
    pd = F.pad(invD, (r, r, r, r), value=0.0)
    ps = F.pad(std2, (r, r, r, r), value=2.0)
    total = torch.zeros((), dtype=torch.int64, device=invD.device)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            diff = torch.abs(invD - pd[dy:dy + H, dx:dx + W])
            close = valid & pv[dy:dy + H, dx:dx + W] & (
                (diff < std2) | (diff < ps[dy:dy + H, dx:dx + W]))
            total += close.sum()
    return int(total)


def check_regularize(H: int, W: int, rcfg, iters: int = 50,
                     device="cuda") -> dict:
    """K5 against its twin regularize_plain on the card at (H, W) with
    the preset's radius and gates: bit for bit (NaN matching NaN) in both
    norms (Tdist and l2, a fifth of the points at nu = inf), and two
    launches alike, on every occupancy pattern of regularize_world (the
    corners with gates of 0, since a corner's window holds one valid
    cell); timed in the preset's norm on the "random" and "edges" grids.
    Bound: operations, from the "random" grid: ~8 float32 operations a
    (valid centre, window offset) pair, 12 more a close pair under Tdist
    (three divisions) or 3 under l2; bytes: five (H, W) planes in, one
    out."""
    grids = {p: regularize_world(H, W, seed=9, device=device, pattern=p)
             for p in REG_PATTERNS}
    patterns = {}
    for pattern, grid in grids.items():
        patterns[pattern] = {}
        for norm in ("Tdist", "l2"):
            cfg = dataclasses.replace(rcfg, ls_norm=norm)
            if pattern == "corners":
                cfg = dataclasses.replace(cfg, min_neighbours=0,
                                          min_close_neighbours=0)
            got = regularize(grid, cfg).inv_depth
            again = regularize(grid, cfg).inv_depth
            want = regularize_plain(grid, cfg).inv_depth
            if not (_same_bits(got, want) and _same_bits(got, again)):
                raise AssertionError(
                    f"K5 {norm} on the {pattern} grid is not bit for bit "
                    f"its twin: {int((got != want).sum())} cells differ")
            valid = grid.occupied
            patterns[pattern][norm] = dict(
                valid=int(valid.sum()),
                kept=int((valid & (got != fu.EMPTY)).sum()),
                nan=int(torch.isnan(got).sum()),
                changed=int((got != grid.inv_depth).sum()))
    grid = grids["random"]
    r = rcfg.radius
    n_valid = int(grid.occupied.sum())
    pairs = close_pairs(grid, r)
    flops = n_valid * (2 * r + 1) ** 2 * 8 + pairs * (
        12 if rcfg.ls_norm != "l2" else 3)
    b, by = bound(H * W * (1 + 4 * 4 + 4), flops)
    out = _times(0.0, lambda: regularize(grid, rcfg),
                 lambda: regularize_plain(grid, rcfg), None, iters, b, by)
    edges = timed(lambda: regularize(grids["edges"], rcfg), iters)
    out.update(radius=r, norm=rcfg.ls_norm, valid=n_valid, close_pairs=pairs,
               flops=flops, by_norm=patterns["random"], patterns=patterns,
               edges_kernel_ms=edges["ms"],
               edges_valid=int(grids["edges"].occupied.sum()),
               shared_bytes=regularize_op.shared_bytes(r))
    return out


def k5_plan(rcfg) -> dict:
    """K5's instantiation for the preset's norm and radius: registers and
    local bytes (CUDA runtime), spills (ptxas), blocks an SM holds,
    shared bytes and threads a block, tile; the Python layout's shared
    bytes must equal the kernel's."""
    info = regularize_op.kernel_info(rcfg.ls_norm != "l2", rcfg.radius)
    if info["smem_bytes"] != regularize_op.shared_bytes(rcfg.radius):
        raise AssertionError(f"K5 takes {info['smem_bytes']} shared bytes "
                             f"at r = {rcfg.radius}, ops/regularize.py says "
                             f"{regularize_op.shared_bytes(rcfg.radius)}")
    rep = ptxas_report(_build.BUILD_LOG.get("regularize.cu", "")).get(
        info["name"], {})
    return dict(info, radius=rcfg.radius, spill_stores=rep.get(
        "spill_stores"), spill_loads=rep.get("spill_loads"),
        warps_per_sm=info["blocks_per_sm"] * info["threads"] // 32)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, a NaN matching a NaN in the same place (the card's
    arithmetic gives every NaN one pattern; a copy keeps its input's)."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        torch.where(na, torch.zeros_like(a), a).view(torch.int32),
        torch.where(nb, torch.zeros_like(b), b).view(torch.int32))


def bm_world(rig: StereoRig, n: int, disp: int, seed: int, device="cuda"):
    """Block matching at the rig's size: _textured_pair's surfaces (a
    `disp`-pixel shift) with a dark corner (a fifth of the columns, a
    quarter of the rows, scaled below 1) for the noise count, and n
    events over the whole image and 2 pixels past it (so windows clamp
    at every border), a twentieth invalid."""
    cam = rig.left
    H, W = cam.height, cam.width
    rng = np.random.default_rng(seed)
    ts_l, ts_r = _textured_pair(rng, W, H, disp)
    ts_l[:H // 4, :W // 5] *= 0.004
    x = np.stack([rng.uniform(-2, W + 2, n), rng.uniform(-2, H + 2, n)], 1)
    t = lambda a: torch.tensor(a, dtype=F32, device=device)
    return (t(ts_l), t(ts_r), t(x),
            torch.tensor(rng.random(n) > 0.05, device=device))


def _bm_plain(fn):
    """fn() with block matching's disparity scan on its plain twin."""
    real = bm.best_disparity
    bm.best_disparity = bm.best_disparity_plain
    try:
        return fn()
    finally:
        bm.best_disparity = real


def k6_plan(wy: int, wx: int, n_disp: int) -> dict:
    """K6's instantiation for a patch and range: T disparities a lane,
    passes, events (warps) a block and shared bytes (the launch plan),
    registers and local bytes (CUDA runtime), spills (ptxas), blocks an
    SM holds."""
    info = block_match_op.kernel_info(wy, wx, n_disp)
    rep = ptxas_report(_build.BUILD_LOG.get("block_match.cu", "")).get(
        info["instantiation"], {})
    return dict(info, n_disp=n_disp, spill_stores=rep.get("spill_stores"),
                spill_loads=rep.get("spill_loads"),
                warps_per_sm=info["blocks_per_sm"]
                * info["events_per_block"])


def k6_shared_loads(wy: int, wx: int, n_disp: int) -> dict:
    """Shared-memory loads a (event, disparity) pair in the plan's
    instantiation, counted from the launch plan (T, passes) and the
    kernel's loops, not measured: `lane`, what one lane issues for one
    of its pairs (a templated lane walks T + wx - 1 strip columns of wy
    words and 2 column sums for its T pairs; the generic one reads two
    words a product and 2 column sums a column: 2 wy wx + 2 wx, as a
    thread a disparity reads them); `warp`, the warp-wide load
    instructions an event issues (the window's 3 wx column sums and,
    templated, its float4s too) over its n_disp pairs."""
    plan = block_match_op.launch_plan(wy, wx, n_disp)
    t, passes = plan["T"], plan["passes"]
    if plan["patch"] == "generic":
        lane = wx * (2 * wy + 2)
        warp = 3 * wx + passes * lane
    else:
        lane = (t + wx - 1) * (wy + 2) / t
        warp = 3 * wx + -(-wy * wx // 4) + passes * (t + wx - 1) * (wy + 2)
    return dict(lane=lane, warp=warp / n_disp)


def check_block_match(rig: StereoRig, cfg: SystemConfig, n: int, disp: int,
                      iters: int = 50) -> dict:
    """K6 (block matching's disparity scan, one launch) against its twin
    best_disparity_plain on the card, at the preset's patch, disparity
    range and smoothing over n events of bm_world: `best`, its cost and
    dark bit for bit on every event, twice (a repeat launch is bitwise);
    through match_events_stats the validity, disparity, cost and the
    failure counters equal; with a NaN in the right surface, torch's
    argmin rule (the first NaN wins) followed; the same bits in the
    swapped patch (up_down's 15x7 instantiation) and a generic one (5x9).
    Timed beside the twin ("slice") and the "matmul" volume (the nearest
    one-strategy yardstick; no PyTorch call computes the function).
    Bound: operations, counted from this run's events: per (event,
    disparity) that stays inside the image, 2 wy wx + 3 wx products and
    sums and 14 more (the moments, the ZNCC, the cost, the comparison);
    per event the right strip's column sums (3 wy (wx + D - 1)) and the
    left window's (4 wy wx + 3 wx + 6); bytes: both surfaces once, ui, vi
    and the three outputs."""
    bcfg = cfg.bm
    cam = rig.left
    H, W = cam.height, cam.width
    ts_l, ts_r, x, valid = bm_world(rig, n, disp, seed=21,
                                    device=cam.mask.device)
    args = (ts_l, ts_r, x, x, torch.zeros(n, device=x.device), valid,
            cam.mask, rig)
    got, gs = bm.match_events_stats(*args, bcfg)
    want, ws = _bm_plain(lambda: bm.match_events_stats(*args, bcfg))
    match_equal = (torch.equal(got.valid, want.valid)
                   and _same_bits(got.disparity, want.disparity)
                   and _same_bits(got.cost, want.cost)
                   and {k: int(v) for k, v in gs.items()}
                   == {k: int(v) for k, v in ws.items()})
    wx, wy = bcfg.patch_size_x, bcfg.patch_size_y
    hx, hy = (wx - 1) // 2, (wy - 1) // 2
    dmin, dmax = bcfg.min_disparity, bcfg.max_disparity
    D = dmax - dmin + 1
    sl, sr = ts_l, ts_r
    if bcfg.smooth_time_surface:
        sl, sr = tsf.gaussian_blur(ts_l, 5), tsf.gaussian_blur(ts_r, 5)
    ui = torch.clamp(torch.floor(x[:, 0]).to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.floor(x[:, 1]).to(torch.int64), 0, H - 1)
    kw = dict(dmin=dmin, dmax=dmax, hy=hy, hx=hx)

    def kernel(a=sl, b=sr, **over):
        return block_match_op.best_disparity(a, b, ui, vi, **{**kw, **over})

    def plain(a=sl, b=sr, strategy="slice", **over):
        k = {**kw, **over}
        return bm.best_disparity_plain(a, b, ui, vi, k["dmin"], k["dmax"],
                                       k["hy"], k["hx"], strategy)

    def same(a, b):
        return all(_same_bits(p, q) for p, q in zip(a, b))

    n0 = block_match_op.KERNEL.launches
    k1, k2, p1 = kernel(), kernel(), plain()
    sr_nan = sr.clone()
    sr_nan[::23, ::37] = float("nan")
    kn, pn = kernel(sl, sr_nan), plain(sl, sr_nan)
    patches = {}
    for name, over in (("swapped", dict(hy=hx, hx=hy)),
                       ("generic", dict(hy=2, hx=4))):
        p = block_match_op.launch_plan(2 * over["hy"] + 1,
                                       2 * over["hx"] + 1, D)
        patches[name] = dict(instantiation=p["instantiation"],
                             bitwise=same(kernel(**over), plain(**over)))
    res = dict(events=n, disparities=D, patch=[wy, wx],
               smoothed=bcfg.smooth_time_surface,
               instantiation=block_match_op.launch_plan(
                   wy, wx, D)["instantiation"],
               launched=block_match_op.KERNEL.launches - n0,
               bitwise=same(k1, p1), repeat_bitwise=same(k1, k2),
               match_equal=match_equal, nan_bitwise=same(kn, pn),
               nan_events=int(torch.isnan(kn[1]).sum()),
               other_patches=patches,
               matched=int(got.valid.sum()),
               best_differs=int((k1[0] != p1[0]).sum()),
               counters={k: int(v) for k, v in gs.items()})
    if not (res["bitwise"] and res["repeat_bitwise"] and match_equal
            and res["nan_bitwise"] and 0 < res["nan_events"] < n
            and res["matched"] > 0 and res["launched"] == 5
            and all(p["bitwise"] for p in patches.values())):
        raise AssertionError(f"K6 differs from its twin: {res}")
    ds = torch.arange(dmin, dmax + 1, device=ui.device)
    inside = int(((ui[:, None] - ds - hx >= 1)
                  & (ui[:, None] - ds + hx < W - 1)).sum())
    flops = inside * (2 * wy * wx + 3 * wx + 14) + n * (
        3 * wy * (wx + D - 1) + 4 * wy * wx + 3 * wx + 6)
    b, by = bound(2 * H * W * 4 + n * (8 + 8 + 8 + 4 + 4), flops)
    out = _times(0.0, kernel, plain, None, iters, b, by)
    mm = timed(lambda: plain(strategy="matmul"), max(1, iters // 10))
    out.update(res, inside_pairs=inside, flops=flops,
               matmul_ms=mm["ms"], matmul_call_ms=mm["call_ms"],
               shared_bytes=block_match_op.shared_bytes(wy, wx, D))
    return out


def k7_bytes(order, pix_sorted, start, hw: int, K: int, kt: int) -> int:
    """The bytes K7's function must move, from this run's sorted order:
    per pixel its 11 grid words read and 11 written; the sorted pixel ids
    inside the grid (8 bytes each) once; each taken slot's order entry (8
    bytes); each distinct candidate that some slot takes, its 8 words
    once (a candidate's kt tiles carry the same words); the camera's 12
    words and the two counts (8 bytes each)."""
    inside = pix_sorted < hw
    pos = torch.arange(pix_sorted.numel(), device=pix_sorted.device)
    first = start[torch.clamp(pix_sorted, max=hw - 1)]
    taken = inside & (pos - first < K)
    distinct = int(torch.unique(order[taken] // kt).numel())
    return (hw * 22 * 4 + int(inside.sum()) * 8 + int(taken.sum()) * 8
            + distinct * 8 * 4 + 12 * 4 + 2 * 8)


def rank_placement(order, pix_sorted, hw: int, K: int) -> torch.Tensor:
    """The slot placement K7 replaced, as the port ran it before K7 read
    runs: the segment rank (a cummax), each kept candidate's slot, and
    the (K, H * W) int32 plane of tiled ids that the fold read."""
    rank = fu._segment_rank(pix_sorted)
    keep = (pix_sorted < hw) & (rank < K)
    slot = torch.where(keep, rank * hw + pix_sorted,
                       torch.full_like(pix_sorted, hw * K))
    ids = torch.full((K * hw + 1,), -1, dtype=torch.int32,
                     device=order.device)
    ids[slot] = order.to(torch.int32)
    return ids[:-1].view(K, hw)


def check_fuse(rig: StereoRig, cfg: SystemConfig, m: int,
               iters: int = 50) -> dict:
    """K7 (the fusion fold with its slot placement, one launch) against
    its twin _assign_slots + fold_slots_plain on the card, on fuse_world's
    grid at the rig's size and m candidates: at fusion radius 0 and 1, in
    Tdist and l2, all 11 planes bit for bit (and a repeat launch),
    num_fused and num_dropped equal, candidates dropped (pixels with more
    than K) in every case, and every rule hit (fuses counted; replaces as
    cells whose x moved); one launch of K7 a call. Timed at the preset's
    radius in Tdist: the kernel; the two sorts before it; the placement
    it replaced (rank_placement) and torch.searchsorted's run bounds
    (fu.run_bounds; the placement's one-call yardstick). Bound: bytes,
    counted from this run's runs by k7_bytes."""
    cam = rig.left
    H, W = cam.height, cam.width
    K = cfg.fusion.max_candidates_per_pixel
    by_case, worlds = {}, {}
    for radius in (0, 1):
        grid, cand = worlds[radius] = fuse_world(H, W, m, seed=31 + radius,
                                                 device=cam.mask.device)
        for norm in ("Tdist", "l2"):
            fcfg = fu.FusionConfig(ls_norm=norm, fusion_radius=radius,
                                   max_candidates_per_pixel=K)
            n0 = fuse_op.KERNEL.launches
            got = fu.fuse_frame(grid, cand, cam, fcfg)
            again = fu.fuse_frame(grid, cand, cam, fcfg)
            launched = fuse_op.KERNEL.launches - n0
            tiled, pix = fu._splat(cand, H, W, radius)
            slot_idx, n_drop = fu._assign_slots(pix, tiled.valid,
                                                tiled.variance, H * W, K)
            want, n_fused = fu.fold_slots_plain(grid, tiled, slot_idx, cam,
                                                fcfg)
            fields = [f.name for f in dataclasses.fields(want)]
            differ = [f for f in fields
                      if not (_same_bits(getattr(got[0], f),
                                         getattr(want, f))
                              and _same_bits(getattr(again[0], f),
                                             getattr(want, f)))]
            rec = dict(launches=launched, fused=int(got[1]),
                       dropped=int(got[2]),
                       changed=int((got[0].inv_depth != grid.inv_depth)
                                   .sum()),
                       inserted=int((~grid.occupied & got[0].occupied)
                                    .sum()),
                       x_moved=int((got[0].x != grid.x).any(-1).sum()),
                       nu_inf=int(torch.isinf(got[0].nu).sum()),
                       differ=differ)
            by_case[f"r{radius}_{norm}"] = rec
            if (differ or launched != 2 or int(got[1]) != int(n_fused)
                    or int(got[2]) != int(n_drop)
                    or int(again[1]) != int(n_fused)
                    or int(again[2]) != int(n_drop) or rec["fused"] == 0
                    or rec["dropped"] == 0 or rec["inserted"] == 0
                    or rec["x_moved"] == 0):
                raise AssertionError(f"K7 r{radius} {norm}: {rec}")
    # a block whose stretch of the sorted order outgrows K7's shared
    # buffer (FUSE_RANGE) searches it in L2: 3,000 candidates x 9 tiles
    # on a 16x16 grid (two blocks)
    grid, cand = fuse_world(16, 16, 3000, seed=33, device=cam.mask.device)
    fcfg = fu.FusionConfig(fusion_radius=1, max_candidates_per_pixel=K)
    got = fu.fuse_frame(grid, cand, cam, fcfg)
    tiled, pix = fu._splat(cand, 16, 16, 1)
    slot_idx, n_drop = fu._assign_slots(pix, tiled.valid, tiled.variance,
                                        256, K)
    want, n_fused = fu.fold_slots_plain(grid, tiled, slot_idx, cam, fcfg)
    rec = by_case["long_stretch"] = dict(
        fused=int(got[1]), dropped=int(got[2]),
        differ=[f.name for f in dataclasses.fields(want)
                if not _same_bits(getattr(got[0], f.name),
                                  getattr(want, f.name))])
    if (rec["differ"] or rec["fused"] != int(n_fused)
            or rec["dropped"] != int(n_drop) or rec["dropped"] == 0):
        raise AssertionError(f"K7 long stretch: {rec}")
    radius = cfg.fusion.fusion_radius
    grid, cand = worlds[radius]
    hw = H * W
    pix, inb = fu._splat_pixels(cand, H, W, radius)
    valid = cand.valid[:, None] & inb

    def sorts():
        return fu._sort_slots(pix, valid, cand.variance[:, None], hw)

    order, pix_sorted = sorts()
    start, end, n_drop = fu.run_bounds(pix_sorted, hw, K)
    taken = int(torch.clamp(end - start, max=K).sum())
    nbytes = k7_bytes(order, pix_sorted, start, hw, K, pix.shape[1])
    planes = dict(invD=grid.inv_depth, var=grid.variance, s2=grid.scale2,
                  nu=grid.nu, res=grid.residual, age=grid.age, x=grid.x,
                  p=grid.p_cam)
    cands = dict(invD=cand.inv_depth, var=cand.variance, s2=cand.scale2,
                 nu=cand.nu, res=cand.residual, age=cand.age, x=cand.x)
    cam_words = fu.camera_words(cam.params.P)
    fcfg = fu.FusionConfig(ls_norm="Tdist", fusion_radius=radius,
                           max_candidates_per_pixel=K)
    tiled, tpix = fu._splat(cand, H, W, radius)
    slot_idx, _ = fu._assign_slots(tpix, tiled.valid, tiled.variance, hw, K)
    b, by = bound(nbytes, 0.0)
    out = _times(0.0,
                 lambda: fuse_op.fuse_runs(planes, cands, order, pix_sorted,
                                           cam_words, K=K, tdist=True),
                 lambda: fu.fold_slots_plain(grid, tiled, slot_idx, cam,
                                             fcfg), None, iters, b, by)
    sort_t = timed(sorts, iters)
    rank_t = timed(lambda: rank_placement(order, pix_sorted, hw, K), iters)
    lib_t = timed(lambda: fu.run_bounds(pix_sorted, hw, K), iters)
    out.update(radius=radius, norm="Tdist", candidates=m,
               tiled=int(pix.numel()), taken=taken, dropped=int(n_drop),
               bytes=nbytes, sort_ms=sort_t["ms"],
               rank_placement_ms=rank_t["ms"],
               placement_library_ms=lib_t["ms"], by_case=by_case)
    return out


# ---------------------------------------------------------------------------
# the mapping cycle
# ---------------------------------------------------------------------------

def _sync(device) -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def gt_rel_err(est: dr.DepthEstimates, points: np.ndarray,
               P: torch.Tensor) -> float:
    """Median relative inverse-depth error of the valid estimates against
    the front-most scene point projecting within 1.5 px of each one in its
    own virtual view."""
    v = est.valid
    if not bool(v.any()):
        return float("nan")
    x, invd = est.x[v], est.inv_depth[v]
    T_cw = se3_inverse(est.T_world_cam[v])
    pts = torch.as_tensor(points, dtype=F32, device=x.device)
    errs = []
    for c in range(0, x.shape[0], 256):
        R, t = T_cw[c:c + 256, :3, :3], T_cw[c:c + 256, :3, 3]
        pc = torch.einsum("nij,mj->nmi", R, pts) + t[:, None, :]
        h = pc @ P[:, :3].T + P[:, 3]
        uv = h[..., :2] / h[..., 2:3]
        near = ((uv - x[c:c + 256, None]).norm(dim=-1) < 1.5) \
            & (pc[..., 2] > 0.1)
        gt = torch.where(near, 1.0 / pc[..., 2],
                         torch.zeros_like(pc[..., 2])).amax(1)
        ok = near.any(1)
        errs.append(((invd[c:c + 256] - gt).abs() / gt)[ok])
    e = torch.cat(errs)
    return float(e.median()) if e.numel() else float("nan")


def _profiled(fn, again=None) -> dict:
    """Wall time of fn unprofiled, then the device busy time, wall time,
    idle share and heaviest kernels of a profiled repeat (of `again`,
    where fn cannot run twice on the same inputs). `idle_share` is the
    profiled run's own, 1 - busy / its wall (which the profiler
    stretches); `idle_share_unprofiled` takes the unprofiled run's wall
    instead. Neither is clamped: a negative one says the profiler's busy
    time exceeds that wall."""
    t0 = _sync("cuda")
    fn()
    wall = (_sync("cuda") - t0) * 1e3
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = _sync("cuda")
        (again or fn)()
        prof_wall = (_sync("cuda") - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy = _device_us(prof) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:4]
    return dict(wall_ms=wall, profiled_wall_ms=prof_wall,
                device_busy_ms=busy, idle_share=1.0 - busy / prof_wall,
                idle_share_unprofiled=1.0 - busy / wall,
                device_launches=sum(e.count for e in dev),
                kernel_launches=kernel_counts(dev),
                rank_scans=sum(e.count for e in dev
                               if RANK_SCAN in e.key),
                top=[dict(kernel=e.key[:70],
                          ms=e.self_device_time_total / 1e3, n=e.count)
                     for e in top])


# how the profiler names each hand-written kernel (the demangled symbols
# of csrc/*.cu: remap_one_kernel / remap_kernel<PPT, NCAM>,
# slice_patches_kernel<RPL, VEC>, lm_kernel<KPL, TDIST>,
# track_solve_kernel, regularize_kernel<TDIST>,
# block_match_kernel<WY, WX, T>, fuse_runs_kernel)
KERNEL_NAMES = {"remap": "remap_", "patches": "slice_patches_kernel<",
                "lm": "lm_kernel<", "track": "track_solve_kernel",
                "regularize": "regularize_kernel<",
                "bm": "block_match_kernel<", "fuse": "fuse_runs_kernel"}


# the kernel of torch.cummax, which the slot placement ran before K7 read
# runs of the sorted order (none is left on the fusion path)
RANK_SCAN = "scan_innermost_dim_with_indices"


def kernel_counts(device_events) -> dict:
    """Launches of K1-K7 among a profile's device events, by kernel name:
    the only count that sees the kernels a CUDA graph replays."""
    return {k: sum(e.count for e in device_events if pat in e.key)
            for k, pat in KERNEL_NAMES.items()}


def profile_cycle(cycle: MappingCycle, args) -> dict:
    """One more estimate + rebuild on the last mapping tick's inputs (the
    window is not pushed), and the regularization pass alone."""
    grid = cycle.rebuild_frame(cycle.history, args[-1])[0]
    out = dict(cycle=_profiled(lambda: (cycle.mapping_estimate(*args),
                                        cycle.rebuild_frame(cycle.history,
                                                            args[-1]))))
    # the wrapper's count too: the profiler may record no device event in
    # a region this short
    n0 = regularize_op.KERNEL.launches
    out["regularize"] = _profiled(lambda: regularize(grid,
                                                     cycle.cfg.regularizer))
    out["regularize"]["k5_launches_per_call"] = (
        regularize_op.KERNEL.launches - n0) / 2
    return out


def run_cycle(name: str, rig: StereoRig, cfg: SystemConfig, scene,
              ticks, frames, device) -> list[dict]:
    """Drive MappingCycle over the ticks; one record per mapping cycle,
    and on the card a profile of the last one."""
    cycle = MappingCycle(rig, cfg, device=device)
    H, W = cycle.H, cycle.W
    fl, fr = frames
    st_l = tsf.init_state(H, W, device)
    st_r = tsf.init_state(H, W, device)
    pose_t = torch.tensor(scene.traj_times, dtype=F32, device=device)
    pose_T = torch.tensor(scene.traj_poses, dtype=F32, device=device)
    P_left = cycle.rig.left.params.P
    out, render_ms = [], []
    for k, t in enumerate(ticks):
        t0 = _sync(device)
        st_l, st_r, s_l, s_r = cycle.render_tick(
            st_l, st_r,
            *[tsf.EventBatch.from_arrays(
                *[f[key][k] for key in ("x", "y", "t", "p", "valid")],
                device=device) for f in (fl, fr)], float(t))
        render_ms.append((_sync(device) - t0) * 1e3)
        if k % MAP_EVERY != MAP_EVERY - 1:
            continue
        T_wf = torch.tensor(interpolate_gt_pose(scene, float(t)), dtype=F32,
                            device=device)
        ev = [torch.as_tensor(fl[key][k], device=device)
              for key in ("x", "y", "t", "valid")]
        t0 = _sync(device)
        est, n_valid, bm_stats = cycle.mapping_estimate(
            s_l, s_r, *ev, pose_t, pose_T, T_wf)
        t1 = _sync(device)
        cycle.push_history(est)
        grid, pts, occ, n_fused, n_drop = cycle.rebuild_frame(cycle.history,
                                                              T_wf)
        t2 = _sync(device)
        N = cycle.N
        if est.inv_depth.shape != (N,) or pts.shape != (H, W, 3):
            raise AssertionError(f"{name}: unexpected output shapes")
        if not (torch.isfinite(est.inv_depth[est.valid]).all()
                and torch.isfinite(pts[occ]).all()
                and torch.isfinite(s_l).all()):
            raise AssertionError(f"{name}: non-finite output")
        out.append(dict(
            slice=name, device=str(device), tick=k,
            render_ms=float(np.mean(render_ms)), estimate_ms=(t1 - t0) * 1e3,
            rebuild_ms=(t2 - t1) * 1e3, events=int(fl["valid"][k].sum()),
            valid=int(n_valid), fused_pixels=int(occ.sum()),
            fusions=int(n_fused), dropped=int(n_drop),
            gt_median_rel_err=gt_rel_err(est, scene.points, P_left),
            bm={kk: int(vv) for kk, vv in bm_stats.items()},
            estimates=est))
        render_ms = []
        last = (s_l, s_r, *ev, pose_t, pose_T, T_wf)
    if torch.device(device).type == "cuda":
        out.append(dict(slice=name, profile=profile_cycle(cycle, last)))
    return out


def regularize_dispatch(records: list[dict], scene, ticks,
                        cfg: SystemConfig, device="cuda") -> dict:
    """A float64 MappingCycle with regularization on the card: the rpg
    cycle's estimates (records of run_cycle) pushed into the window of a
    cycle on a float64 rpg rig, then rebuild_frame. K5 takes float32
    grids only, so the float64 grid goes to regularize_plain on the card
    (no K5 launch); the regularized grid must equal regularize_plain on
    the CPU on the same grid (float64, elementwise: bit for bit
    expected, gated at rtol 1e-12), and the points be finite."""
    import esvo_tpu_torch.runtime.system as system_module
    f64 = torch.float64
    cycle = MappingCycle(make_rig("rpg", device, f64), cfg, device=device)
    for rec in records:
        cycle.push_history(_tree(rec["estimates"], lambda a: a.to(f64)
                                 if a.is_floating_point() else a))
    t = float(ticks[records[-1]["tick"]])
    T = torch.tensor(interpolate_gt_pose(scene, t), dtype=f64, device=device)
    calls = []
    real = system_module.regularize

    def recorded(grid, rcfg):
        out = real(grid, rcfg)
        calls.append((grid, out))
        return out

    n0 = regularize_op.KERNEL.launches
    system_module.regularize = recorded
    try:
        t0 = _sync(device)
        grid, pts, occ, _, _ = cycle.rebuild_frame(cycle.history, T)
        ms = (_sync(device) - t0) * 1e3
    finally:
        system_module.regularize = real
    k5 = regularize_op.KERNEL.launches - n0
    before, after = calls[0]
    want = regularize_plain(_tree(before, lambda a: a.cpu()),
                            cfg.regularizer).inv_depth
    got = after.inv_depth.cpu()
    occupied = before.occupied.cpu()
    res = dict(regularize_dispatch="rpg float64 MappingCycle",
               dtype=str(grid.inv_depth.dtype), rebuild_ms=ms,
               k5_launches=k5, occupied=int(occupied.sum()),
               kept=int((occupied & (got != fu.EMPTY)).sum()),
               bitwise=torch.equal(got, want),
               max_abs_err=float((got - want).abs().max()),
               points_finite=bool(torch.isfinite(pts[occ]).all()))
    if not (grid.inv_depth.dtype == f64 and k5 == 0
            and res["points_finite"] and 0 < res["kept"] < res["occupied"]
            and torch.equal(got == fu.EMPTY, want == fu.EMPTY)
            and torch.allclose(got, want, rtol=1e-12, atol=0.0)):
        raise AssertionError(f"float64 regularization on the card: {res}")
    return res


def _public(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k != "estimates"}


def compare_to_cpu(card: list[dict], ref: list[dict],
                   label: str = "rpg cycle, card vs CPU port") -> dict:
    """Card cycle against the CPU port's (the twins) on the same events:
    validity on >= 98% of the events, the inverse depth within the LM
    tolerance (rtol 2e-4, atol 2e-5) on >= 95% of those valid in both."""
    agree, worst, close = [], 0.0, []
    for a, b in zip(card, ref):
        va, vb = a["estimates"].valid.cpu(), b["estimates"].valid
        agree.append(float((va == vb).float().mean()))
        both = va & vb
        da = a["estimates"].inv_depth.cpu()[both]
        db = b["estimates"].inv_depth[both]
        if both.any():
            worst = max(worst, float((da - db).abs().max()))
            close.append(float(torch.isclose(da, db, rtol=2e-4,
                                             atol=2e-5).float().mean()))
    res = dict(compare=label, cycles=len(agree),
               validity_agreement_min=min(agree),
               inv_depth_max_abs_err=worst,
               inv_depth_within_lm_tol_min=min(close) if close else None)
    if not (len(agree) == len(card) and min(agree) >= 0.98
            and (not close or min(close) >= 0.95)):
        raise AssertionError(f"card and CPU cycles disagree: {res}")
    return res


# ---------------------------------------------------------------------------
# the closed loop
# ---------------------------------------------------------------------------

def _roll_inputs(frames, ticks, k0: int):
    sl = slice(k0, k0 + ROLL)
    return (ticks[sl],) + tuple(
        {k: v[sl] for k, v in f.items() if k != "dropped"} for f in frames)


def _time_stages(system: EsvoSystem, device, times: list) -> None:
    """Wrap the system's mapping dispatch and SGM bootstrap so each call
    is timed between synchronizations (ms appended to `times`)."""
    for name in ("_dispatch_mapping", "_sgm_bootstrap"):
        fn = getattr(system, name)

        def timed_stage(*a, _fn=fn, **kw):
            t0 = _sync(device)
            out = _fn(*a, **kw)
            times.append((_sync(device) - t0) * 1e3)
            return out
        setattr(system, name, timed_stage)


def pose_angle(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """Angle (rad) between two rotations, exact near zero."""
    E = Ra @ Rb.T
    w = 0.5 * np.array([E[2, 1] - E[1, 2], E[0, 2] - E[2, 0],
                        E[1, 0] - E[0, 1]])
    return float(np.arctan2(np.linalg.norm(w), (np.trace(E) - 1) / 2))


def run_closed_loop(rig: StereoRig, cfg: SystemConfig, scene, ticks, frames,
                    device, log_rolls: bool = True, seed: int = 0) -> dict:
    """EsvoSystem over LOOP_ROLLS rolls of ROLL ticks, as the JAX
    package's closed-loop benchmark drives it, then flush(). Returns the
    system, the per-roll records, the ATE (and a static pose's) and the
    bootstrap's surfaces. `seed` seeds the tracker's point selection."""
    system = EsvoSystem(rig, cfg, device=device, seed=seed)
    stage_ms: list = []
    _time_stages(system, device, stage_ms)
    rolls, boot = [], None
    for r in range(LOOP_ROLLS):
        t_r, ev_l, ev_r = _roll_inputs(frames, ticks, r * ROLL)
        n_stage = len(stage_ms)
        t0 = _sync(device)
        out = system.process_ticks(t_r, ev_l, ev_r)
        wall = (_sync(device) - t0) * 1e3
        if "sgm_points" in out and boot is None:
            boot = (out["ts_left"], out["ts_right"], out["sgm_points"])
        rec = dict(roll=r, device=str(device), status=out["status"],
                   roll_ms=wall, ms_per_tick=wall / ROLL,
                   mapping_ms=sum(stage_ms[n_stage:]),
                   map_points=out["map_points"],
                   sgm_points=out.get("sgm_points"),
                   map_estimates=out.get("map_estimates"),
                   lm_stats=out.get("lm_stats"))
        rolls.append(rec)
        if log_rolls:
            log(dict(closed_loop="rpg", **rec))
    system.flush()
    t_est, T_est = system.trajectory()
    if not np.isfinite(T_est).all():
        raise AssertionError("closed loop: a non-finite pose")
    gt = np.stack([interpolate_gt_pose(scene, t) for t in t_est])
    static = np.repeat(np.eye(4)[None], len(t_est), axis=0)
    return dict(system=system, rolls=rolls, boot=boot, traj=(t_est, T_est),
                ate=ate_rmse(t_est, T_est, t_est, gt, align=True),
                static_ate=ate_rmse(t_est, static, t_est, gt, align=True),
                ticks=len(t_est), stage_ms=stage_ms)


def run_live_ticks(rig: StereoRig, cfg: SystemConfig, ticks, frames,
                   device) -> dict:
    """EsvoSystem through process_tick one tick at a time over the
    stream (the live path; a mapping tick every MAP_EVERY), the tracer
    on. Returns the system, each tick's wall (ms, to a sync) and whether
    it tracked, and the tracer's counters: ``tick.replays`` /
    ``tick.eager`` (ticks a graph served / run eagerly),
    ``graph.captures`` (the ticks' graphs and the cycle's)."""
    system = EsvoSystem(rig, cfg, device=device)
    walls, tracked = [], []
    tracer.enable()
    try:
        for k in range(len(ticks)):
            frame = lambda f: {key: v[k] for key, v in f.items()
                               if key != "dropped"}
            t0 = _sync(device)
            out = system.process_tick(float(ticks[k]), *map(frame, frames),
                                      do_mapping=k % MAP_EVERY
                                      == MAP_EVERY - 1)
            walls.append((_sync(device) - t0) * 1e3)
            tracked.append("lm_stats" in out)
        counters = tracer.take()["counters"]
    finally:
        tracer.disable()
    return dict(system=system, walls=walls, tracked=tracked,
                counters=counters)


def profile_tracked_roll(system: EsvoSystem, ticks, frames) -> dict:
    """Two more tracked rolls without a mapping cycle: the first's wall
    time, the second's device busy time and launches (_profiled)."""
    k0 = LOOP_ROLLS * ROLL
    first = _roll_inputs(frames, ticks, k0)
    second = _roll_inputs(frames, ticks, k0 + ROLL)
    prof = _profiled(lambda: system.process_ticks(*first, do_mapping=False),
                     again=lambda: system.process_ticks(*second,
                                                        do_mapping=False))
    prof["launches_per_tick"] = prof["device_launches"] / ROLL
    prof["wall_ms_per_tick"] = prof["wall_ms"] / ROLL
    return prof


def check_tracking_solve(system: EsvoSystem, cpu_rig: StereoRig,
                         cfg: SystemConfig) -> dict:
    """One tracking solve on the card and through the CPU port, on the same
    surface and the same selected points; the pose must agree within the
    CPU parity test's tolerance (1e-4 m, 1e-4 rad)."""
    ref = system._current_ref_map()
    pts, ok = system.select_ref_points(ref[0], ref[1])
    st_l = system.ts_state_left
    s_l = system.cycle.render_left(st_l, system.last_tick_time)
    T_wf = system._tensor(system.T_world_frame)
    T_cur = system._tensor(system.T_world_cur)
    t0 = _sync("cuda")
    T_card, rms_card = system.track(s_l, T_wf, T_cur, pts, ok)
    card_ms = (_sync("cuda") - t0) * 1e3
    cpu = EsvoSystem(cpu_rig, cfg, device="cpu")
    t0 = time.perf_counter()
    T_cpu, rms_cpu = cpu.track(s_l.cpu(), T_wf.cpu(), T_cur.cpu(), pts.cpu(),
                               ok.cpu())
    cpu_ms = (time.perf_counter() - t0) * 1e3
    a, b = T_card.double().cpu().numpy(), T_cpu.double().numpy()
    res = dict(compare="rpg tracking solve, card vs CPU port",
               points=int(ok.sum()), t_diff_m=float(np.linalg.norm(
                   a[:3, 3] - b[:3, 3])),
               R_diff_rad=pose_angle(a[:3, :3], b[:3, :3]),
               rms_card=rms_card.cpu().tolist(), rms_cpu=rms_cpu.tolist(),
               card_ms=card_ms, cpu_ms=cpu_ms)
    if not (res["t_diff_m"] < 1e-4 and res["R_diff_rad"] < 1e-4):
        raise AssertionError(f"tracking solve: card and CPU disagree: {res}")
    return res


def check_sgm(boot, cfg: SystemConfig) -> dict:
    """The bootstrap's SGM on the card and through the CPU port on the same
    surfaces: best disparity and validity on >= 99.5% of the pixels (the
    CPU parity test's bar on rendered surfaces), and both times."""
    s_l, s_r, _ = boot
    sgm = lambda a, b: init.semi_global_matching(a, b, cfg.sgm)
    t0 = _sync("cuda")
    d_card, v_card = sgm(s_l, s_r)
    card_ms = (_sync("cuda") - t0) * 1e3
    t0 = time.perf_counter()
    d_cpu, v_cpu = sgm(s_l.cpu(), s_r.cpu())
    cpu_ms = (time.perf_counter() - t0) * 1e3
    d_card, v_card = d_card.cpu(), v_card.cpu()
    res = dict(compare="rpg SGM bootstrap, card vs CPU port",
               best_disparity_agreement=float(
                   (torch.round(d_card) == torch.round(d_cpu)).float().mean()),
               valid_agreement=float((v_card == v_cpu).float().mean()),
               valid_share=float(v_cpu.float().mean()), card_ms=card_ms,
               cpu_ms=cpu_ms)
    if min(res["best_disparity_agreement"], res["valid_agreement"]) < 0.995:
        raise AssertionError(f"SGM: card and CPU disagree: {res}")
    return res


# ---------------------------------------------------------------------------
# the resident loop
# ---------------------------------------------------------------------------

def stream_dispatches(evs, ticks, cap: int, R: int):
    """Roll 0 (ROLL ticks, for the host path's bootstrap), then dispatches
    of R whole rolls, each (t_syncs, left frames, right frames), framed
    by EventFrameStream with its prefetch thread."""
    streams = [EventFrameStream(e, ticks, cap) for e in evs]
    rolls = ((t, fl, fr) for (t, fl), (_, fr) in
             zip(*(s.rolls(ROLL) for s in streams)) if len(t) == ROLL)
    yield next(rolls)
    group = []
    for roll in rolls:
        group.append(roll)
        if len(group) == R:
            yield (np.concatenate([g[0] for g in group]),
                   *({k: np.concatenate([g[i][k] for g in group])
                      for k in group[0][i]} for i in (1, 2)))
            group = []


def check_graph_roll(loop: ResidentLoop, t_syncs, ev_l, ev_r) -> dict:
    """One roll replayed by the graph against the same roll run eagerly
    from a clone of the state, with the same scores (drawn from a
    generator of their own, so the system's stream does not move); the
    state is restored afterwards. Poses within 1e-4 m and 1e-4 rad, map
    points and accept flags equal."""
    snap = loop.state.map(torch.clone)
    dev = loop.system.device
    gen = torch.Generator(device=dev).manual_seed(11)
    scores = torch.rand(loop.system.H * loop.system.W, device=dev,
                        generator=gen)
    loop.stage(t_syncs, ev_l, ev_r, scores=scores)
    graph = unpack(loop.step().cpu().numpy(), loop.K)
    eager = unpack(loop.roll(snap.map(torch.clone), loop.inputs)[1].cpu()
                   .numpy(), loop.K)
    loop.state.copy_(snap)
    pairs = list(zip(graph["poses"], eager["poses"]))
    res = dict(check="resident roll: graph replay vs eager",
               t_diff_m=max(float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
                            for a, b in pairs),
               R_diff_rad=max(pose_angle(a[:3, :3], b[:3, :3])
                              for a, b in pairs),
               map_points=[int(graph["map_points"]),
                           int(eager["map_points"])],
               accepted=[graph["accepted"].tolist(),
                         eager["accepted"].tolist()])
    if not (res["t_diff_m"] < 1e-4 and res["R_diff_rad"] < 1e-4
            and graph["map_points"] == eager["map_points"]
            and (graph["accepted"] == eager["accepted"]).all()):
        raise AssertionError(f"graph and eager rolls disagree: {res}")
    return res


def time_replay(loop: ResidentLoop, n: int = 3) -> list:
    """Device span of one graph replay, by CUDA events, n times on the
    staged inputs, each from the same state (restored after): the
    profiler-free check on its busy time a roll."""
    snap = loop.state.map(torch.clone)
    spans = []
    for _ in range(n):
        loop.state.copy_(snap)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        loop.step()
        e1.record()
        e1.synchronize()
        spans.append(e0.elapsed_time(e1))
    loop.state.copy_(snap)
    torch.cuda.synchronize()
    return spans


def run_resident(rig: StereoRig, cfg: SystemConfig, scene, ticks, evs,
                 host_traj=None, device="cuda") -> dict:
    """The resident loop on the rpg scene, seed 0: roll 0 bootstraps on
    the host path, then ResidentLoop (ROLL ticks a roll, RESIDENT_R rolls
    a dispatch) over every whole dispatch the scene holds: the first
    (capture + replay), a graph-vs-eager check roll, the timed dispatches
    (one synchronization at the end), one more for the wall time and the
    last one profiled. Logs its lines and returns the summary."""
    system = EsvoSystem(rig, cfg, device=device, seed=0)
    batches = stream_dispatches(evs, ticks, SCENES["rpg"]["cap"], RESIDENT_R)
    system.process_ticks(*next(batches))            # the SGM bootstrap
    if system.status.value != "WORKING":
        raise AssertionError("resident: the bootstrap roll left the system "
                             f"in {system.status.value}")
    batches = list(batches)
    loop = ResidentLoop(system, ROLL, RESIDENT_R)
    loop.start()
    t0 = _sync(device)
    loop.run(*batches[0])
    first_ms = (_sync(device) - t0) * 1e3
    log(dict(resident="rpg", card=card_line(), warmup_ms=loop.warmup_ms,
             capture_ms=loop.capture_ms, first_dispatch_ms=first_ms))
    first = batches[1]
    check = check_graph_roll(loop, first[0][:ROLL],
                             *({k: v[:ROLL] for k, v in ev.items()}
                               for ev in first[1:]))
    log(dict(check, card=card_line()))
    timed = batches[1:-2]
    t0 = _sync(device)
    for b in timed:
        loop.run(*b)
    wall = _sync(device) - t0
    n_ticks = len(timed) * RESIDENT_R * ROLL
    prof = _profiled(lambda: loop.run(*batches[-2]),
                     again=lambda: loop.run(*batches[-1]))
    spans = time_replay(loop)
    # the share of an unprofiled dispatch's wall outside its replays'
    # device spans: a lower bound on its idle share, free of the profiler
    prof.update(replay_event_ms=spans,
                busy_per_roll_ms=prof["device_busy_ms"] / RESIDENT_R,
                busy_exceeds_wall=prof["device_busy_ms"]
                > prof["profiled_wall_ms"],
                idle_share_outside_replays=1.0 - RESIDENT_R
                * float(np.median(spans)) / prof["wall_ms"],
                replay_ms_per_tick=float(np.median(spans)) / ROLL)
    summary = loop.finish()
    t_est, T_est = system.trajectory()
    if not np.isfinite(T_est).all():
        raise AssertionError("resident: a non-finite pose")
    gt = np.stack([interpolate_gt_pose(scene, t) for t in t_est])
    res = dict(resident="rpg", card=card_line(), status=system.status.value,
               rolls_since_good=summary["rolls_since_good"],
               ticks=len(t_est), dispatches=len(batches),
               rolls_per_dispatch=RESIDENT_R, timed_ticks=n_ticks,
               ms_per_tick=wall * 1e3 / n_ticks, ticks_per_s=n_ticks / wall,
               ate_m=ate_rmse(t_est, T_est, t_est, gt, align=True),
               ate_bar_m=CLOSED_LOOP_ATE_BAR,
               tracking_rejects=system.stats["tracking_rejects"],
               map_points=summary["map_points"],
               profiled_dispatch=dict(
                   prof, kernels_per_roll=prof["device_launches"] / RESIDENT_R,
                   launches_per_roll={k: v / RESIDENT_R for k, v in
                                      prof["kernel_launches"].items()}),
               before_k4_k5=RESIDENT_BEFORE_K4_K5)
    if host_traj is not None:
        t_h, T_h = host_traj
        common = {float(t): i for i, t in enumerate(t_h)}
        pairs = [(T, T_h[common[float(t)]]) for t, T in zip(t_est, T_est)
                 if float(t) in common]
        res["vs_host_path"] = dict(
            ticks=len(pairs),
            max_t_diff_m=max(float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
                             for a, b in pairs),
            max_R_diff_rad=max(pose_angle(a[:3, :3], b[:3, :3])
                               for a, b in pairs))
    return res


# ---------------------------------------------------------------------------
# the mapper benchmark (MVStereoSystem) and the dataset runner
# ---------------------------------------------------------------------------

MV_TICKS = 30
# tests/test_mvstereo.py's event-matcher config: 15x15 patches, whose
# 16x16 windows go to kernel K1
MV_EM = dict(time_threshold=2e-3, epipolar_threshold=1.0,
             ts_ncc_threshold=0.4, patch_size_x=15, patch_size_y=15,
             max_candidates=32)
# per mode, the stage its card-vs-CPU comparison replays, and its owner
MV_STAGES = {0: ("system", "em_estimate"), 1: ("cycle", "seed_frame"),
             2: ("system", "refine"), 3: ("cycle", "mapping_estimate"),
             4: ("cycle", "seed_frame")}
DATASET_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_dataset"
T0_ABS = 1468941032.0      # epoch-scale bag stamps, as in real rpg bags


def _tree(obj, fn):
    """fn on every tensor of a call's arguments or result (tuples, lists,
    dicts and dataclasses rebuilt)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_tree(o, fn) for o in obj)
    if isinstance(obj, dict):
        return {k: _tree(v, fn) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return type(obj)(**{f.name: _tree(getattr(obj, f.name), fn)
                            for f in dataclasses.fields(obj)})
    return obj


def record_calls(owner, name: str, calls: list) -> None:
    """Wrap owner.name so each call's arguments and result are kept as
    device-side copies (no sync) in `calls`."""
    fn = getattr(owner, name)

    def recorded(*args):
        out = fn(*args)
        clone = lambda t: t.detach().clone()
        calls.append((_tree(args, clone), _tree(out, clone)))
        return out
    setattr(owner, name, recorded)


def frame_rel_err(system: EsvoSystem, scene) -> float:
    """gt_rel_err of the system's current depth frame (each occupied
    cell a point seen from the frame's pose)."""
    g = system.grid
    occ = g.occupied.reshape(-1)
    T = system._tensor(system.T_world_frame)
    est = SimpleNamespace(valid=occ, x=g.x.reshape(-1, 2),
                          inv_depth=g.inv_depth.reshape(-1),
                          T_world_cam=T.expand(occ.shape[0], 4, 4))
    return gt_rel_err(est, scene.points, system.cycle.left_P)


def run_mvstereo(rig: StereoRig, cfg: SystemConfig, scene, ticks, frames,
                 mode, device="cuda", calls: list | None = None):
    """MVStereoSystem in `mode` over MV_TICKS ticks with the scene's
    ground-truth poses, a mapping cycle every MAP_EVERY ticks; the
    replayed stage's calls go to `calls`. Returns (system, ms of each
    mapping tick: host wall around the tick, ending in a sync)."""
    system = mv.MVStereoSystem(rig, mode, cfg,
                               em_config=EventMatcherConfig(**MV_EM),
                               device=device)
    if calls is not None:
        owner, name = MV_STAGES[int(mode)]
        record_calls(system if owner == "system" else system.cycle, name,
                     calls)
    fl, fr = frames
    cycle_ms = []
    for k in range(MV_TICKS):
        t = float(ticks[k])
        frame = lambda f: {key: v[k] for key, v in f.items()
                           if key != "dropped"}
        do_map = k % MAP_EVERY == MAP_EVERY - 1
        t0 = _sync(device)
        system.process_tick(t, frame(fl), frame(fr),
                            gt_pose=interpolate_gt_pose(scene, t),
                            do_mapping=do_map)
        if do_map:
            cycle_ms.append((_sync(device) - t0) * 1e3)
    return system, cycle_ms


def compare_mv_stage(mode, calls: list, cpu: mv.MVStereoSystem) -> dict:
    """The mode's recorded stage replayed by the CPU port on the card's
    inputs. Mode 0: the matcher's validity on >= 99% of the events and
    the disparity within 1e-5 relative where both matched; modes 2 and 3:
    compare_to_cpu's LM tolerance; mode 1: the naive fusion's map points
    equal; mode 4 (SGM points): its cells equal on > 99% of the image and
    its map points within 0.5%."""
    mode = mv.MVStereoMode(mode)
    label = f"mvstereo {mode.name.lower()}, card vs CPU port"
    host = lambda obj: _tree(obj, lambda t: t.cpu())
    replay = getattr(cpu if MV_STAGES[int(mode)][0] == "system"
                     else cpu.cycle, MV_STAGES[int(mode)][1])
    pairs = [(host(out), replay(*host(args))) for args, out in calls]
    if mode in (mv.MVStereoMode.EM_PLUS_ESTIMATION,
                mv.MVStereoMode.BM_PLUS_ESTIMATION):
        est = lambda out: out if mode == 2 else out[0]
        return compare_to_cpu([dict(estimates=est(a)) for a, _ in pairs],
                              [dict(estimates=est(b)) for _, b in pairs],
                              label)
    if mode == mv.MVStereoMode.PURE_EVENT_MATCHING:
        agree, worst = [], 0.0
        for (ma, _), (mb, _) in pairs:
            agree.append(float((ma.valid == mb.valid).float().mean()))
            both = ma.valid & mb.valid
            if both.any():
                rel = ((ma.disparity[both] - mb.disparity[both]).abs()
                       / mb.disparity[both].abs())
                worst = max(worst, float(rel.max()))
        res = dict(compare=label, cycles=len(pairs),
                   valid_agreement_min=min(agree),
                   disparity_max_rel_err=worst,
                   matched=[int(a[0].valid.sum()) for a, _ in pairs])
        if not (pairs and min(agree) >= 0.99 and worst <= 1e-5):
            raise AssertionError(f"matcher: card and CPU disagree: {res}")
        return res
    points = [(int(a[2].sum()), int(b[2].sum())) for a, b in pairs]
    cells = min(float((a[2] == b[2]).float().mean()) for a, b in pairs)
    res = dict(compare=label, cycles=len(pairs),
               map_points_card_cpu=points, cell_agreement_min=cells)
    if mode == mv.MVStereoMode.PURE_BLOCK_MATCHING:
        ok = all(a == b for a, b in points)
    else:
        # SGM points sit on integer pixels, the naive fusion's cell
        # borders, and a point of an earlier frame propagated to one may
        # fall either side by a rounding of the card or the CPU
        ok = cells > 0.99 and all(abs(a - b) <= 0.005 * b
                                  for a, b in points)
    if not (pairs and ok):
        raise AssertionError(f"naive fusion: card and CPU disagree: {res}")
    return res


def mvstereo_phase(rigs, cpu_rig, cfg: SystemConfig, stream, card) -> dict:
    """The five MVStereo modes on the rpg rig, preset and scene: one line
    each (mapping-tick ms, map points, error against the scene, K1-K7
    launches, peak memory) and one card-vs-CPU comparison each. Returns
    {mode name: launches}."""
    scene, ticks, frames = stream
    launches = {}
    for mode in mv.MVStereoMode:
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        calls = []
        system, cycle_ms = run_mvstereo(rigs["rpg"], cfg, scene, ticks,
                                        frames, mode, calls=calls)
        peak = torch.cuda.max_memory_allocated()
        n = launch_counts()
        launches[mode.name.lower()] = n
        rec = dict(mvstereo=mode.name.lower(), mode=int(mode), card=card,
                   ticks=MV_TICKS, mapping_cycles=len(cycle_ms),
                   cycle_ms_median=float(np.median(cycle_ms)),
                   cycle_ms_range=[min(cycle_ms), max(cycle_ms)],
                   map_points=system.stats["map_points"],
                   gt_median_rel_err=frame_rel_err(system, scene),
                   launches=n, max_memory_allocated_bytes=peak)
        log(rec)
        cpu = mv.MVStereoSystem(cpu_rig, mode, cfg,
                                em_config=EventMatcherConfig(**MV_EM),
                                device="cpu")
        log(dict(compare_mv_stage(mode, calls, cpu), card=card))
        want = dict(remap=1, patches=int(mode) in (0, 2, 3),
                    lm=int(mode) in (2, 3))
        if rec["map_points"] <= 0 or any(n[k] < v for k, v in want.items()):
            raise AssertionError(f"mvstereo {mode.name}: {rec}")
    return launches


def dsec_em_cycle(rig: StereoRig, cfg: SystemConfig, stream, card,
                  device="cuda") -> dict:
    """One mode-0 mapping cycle at DSEC scale (N = 10000, the default
    matcher config: 25x25 patches, whose 26-row windows do not go to
    K1): the mapping tick's ms, the matcher's window overflow, the peak
    memory of the tick."""
    scene, ticks, (fl, fr) = stream
    system = mv.MVStereoSystem(rig, mv.MVStereoMode.PURE_EVENT_MATCHING,
                               cfg, device=device)
    stats = []

    def with_stats(*args):
        matches, st = match_events_temporal_stats(*args)
        stats.append(st)
        return matches

    plain = mv.match_events_temporal
    mv.match_events_temporal = with_stats
    try:
        for k in range(MAP_EVERY):
            t = float(ticks[k])
            frame = lambda f: {key: v[k] for key, v in f.items()
                               if key != "dropped"}
            if k == MAP_EVERY - 1:
                launches0 = patches.KERNEL.launches
                torch.cuda.reset_peak_memory_stats()
                t0 = _sync(device)
            out = system.process_tick(t, frame(fl), frame(fr),
                                      gt_pose=interpolate_gt_pose(scene, t),
                                      do_mapping=k == MAP_EVERY - 1)
        ms = (_sync(device) - t0) * 1e3
    finally:
        mv.match_events_temporal = plain
    res = dict(dsec_em="mode 0, one mapping cycle", card=card,
               events=int(fl["valid"][MAP_EVERY - 1].sum()), N=system.N,
               patch=[EventMatcherConfig().patch_size_y,
                      EventMatcherConfig().patch_size_x],
               mapping_tick_ms=ms,
               window_overflow=int(stats[-1]["window_overflow"]),
               map_estimates=out["map_estimates"],
               map_points=out["map_points"],
               k1_launches=patches.KERNEL.launches - launches0,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    if len(stats) != 1 or res["map_estimates"] <= 0:
        raise AssertionError(f"DSEC EM cycle failed: {res}")
    return res


def _bag_fields(fields: dict) -> bytes:
    return b"".join(struct.pack("<I", len(k) + 1 + len(v)) + k.encode()
                    + b"=" + v for k, v in fields.items())


def _bag_record(fields: dict, data: bytes) -> bytes:
    hdr = _bag_fields(fields)
    return (struct.pack("<I", len(hdr)) + hdr
            + struct.pack("<I", len(data)) + data)


def _bag_string(s: str) -> bytes:
    return struct.pack("<I", len(s)) + s.encode()


def _stamp(t: float) -> bytes:
    sec = int(t)
    return struct.pack("<II", sec, int(round((t - sec) * 1e9)))


def write_dataset_bag(path: Path, rig: StereoRig, scene, evs) -> None:
    """A rosbag v2.0 of the scene as a stereo DAVIS would record it:
    both cameras' raw events (1 ms dvs_msgs/EventArray messages, through
    the port's writer), then each camera's sensor_msgs/CameraInfo and the
    ground truth as geometry_msgs/PoseStamped, at epoch-scale stamps."""
    H, W = rig.left.height, rig.left.width
    rosbag.write_events_bag(str(path), {
        topic: EventArray(t=e.t + T0_ABS, x=e.x, y=e.y, p=e.p)
        for topic, e in zip(("/davis/left/events", "/davis/right/events"),
                            evs)}, period=1e-3, height=H, width=W)
    conn = lambda c, topic, kind: _bag_record(
        {"op": b"\x07", "conn": struct.pack("<I", c),
         "topic": topic.encode()},
        _bag_fields({"type": kind.encode(), "md5sum": b"*"}))
    msg = lambda c, t, data: _bag_record(
        {"op": b"\x02", "conn": struct.pack("<I", c), "time": _stamp(t)},
        data)
    out = [conn(2, "/davis/left/camera_info", "sensor_msgs/CameraInfo"),
           conn(3, "/davis/right/camera_info", "sensor_msgs/CameraInfo"),
           conn(4, "/gt/pose", "geometry_msgs/PoseStamped")]
    for c, cam in ((2, rig.left), (3, rig.right)):
        prm = cam.params
        f64 = lambda a: a.double().cpu().numpy().astype("<f8").tobytes()
        out.append(msg(c, T0_ABS, struct.pack("<III", 0, 0, 0)
                       + _bag_string("davis") + struct.pack("<II", H, W)
                       + _bag_string(prm.model)
                       + struct.pack("<I", prm.D.numel()) + f64(prm.D)
                       + f64(prm.K) + f64(prm.R) + f64(prm.P)
                       + struct.pack("<IIIIII?", 0, 0, 0, 0, 0, 0, False)))
    q = rot_to_quat(torch.as_tensor(scene.traj_poses[:, :3, :3])).numpy()
    for i, (t, T) in enumerate(zip(scene.traj_times, scene.traj_poses)):
        out.append(msg(4, T0_ABS + t, struct.pack("<I", i) + _stamp(T0_ABS + t)
                       + _bag_string("world")
                       + struct.pack("<7d", *T[:3, 3], *q[i])))
    with open(path, "ab") as f:
        f.write(b"".join(out))


def run_dataset_phase(rig: StereoRig, card, device="cuda") -> dict:
    """scripts/torch_run_dataset.py's main() on a bag of the rpg scene
    that carries its own camera_info and ground truth (no --calib, no
    preset: the defaults, which are the rpg preset): the closed loop on
    the host path in rolls of 5, the same through the resident loop, and
    --mode mvstereo. One line each; returns {run: launches}."""
    scene, _, evs = make_events("rpg", rig)
    DATASET_DIR.mkdir(parents=True, exist_ok=True)
    bag = DATASET_DIR / "rpg_scene.bag"
    bag.unlink(missing_ok=True)
    write_dataset_bag(bag, rig, scene, evs)
    spec = importlib.util.spec_from_file_location(
        "torch_run_dataset",
        Path(__file__).resolve().parent / "scripts" / "torch_run_dataset.py")
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    base = ["--bag", str(bag), "--bag-gt-topic", "/gt/pose",
            "--capacity", str(SCENES["rpg"]["cap"]), "--quiet"]
    runs = {"closed": ["--mode", "closed", "--roll", str(ROLL)],
            "closed_resident": ["--mode", "closed", "--roll", str(ROLL),
                                "--resident", str(RESIDENT_R)],
            "mvstereo": ["--mode", "mvstereo"]}
    launches = {}
    for name, extra in runs.items():
        reset_launches()
        res = runner.main(base + extra
                          + ["--out", str(DATASET_DIR / f"{name}.txt")],
                          device=device)
        launches[name] = launch_counts()
        rec = dict(run_dataset=name, card=card, argv=extra,
                   ticks=res["ticks"], wall_s=res["wall_s"],
                   ticks_per_s=res["ticks"] / res["wall_s"],
                   ate_m=res.get("ate_rmse_m"),
                   rpe_trans_m=res.get("rpe_trans_rmse_m"),
                   map_points=res["stats"]["map_points"],
                   launches=launches[name])
        log(rec)
        closed = name.startswith("closed")
        if rec["map_points"] <= 0 or (closed and not (
                rec["ate_m"] < CLOSED_LOOP_ATE_BAR)):
            raise AssertionError(f"run_dataset {name} failed: {rec}")
    return launches


def demo_phase(card, device="cuda") -> dict:
    """examples/torch_run_synthetic.py, the port of the README's demo, at
    its defaults (60 ticks, no backends) on the card: WORKING, its ATE
    under its own bar (its main raises otherwise) and K4 launched (its
    config turns regularization off, so K5 is not). Returns its
    launches."""
    spec = importlib.util.spec_from_file_location(
        "torch_run_synthetic",
        Path(__file__).resolve().parent / "examples"
        / "torch_run_synthetic.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    reset_launches()
    res = demo.main(["--device", device])
    launches = launch_counts()
    rec = dict(demo="examples/torch_run_synthetic.py", card=card,
               ticks_per_s=res["ticks"] / res["wall_s"], launches=launches,
               **res)
    log(rec)
    if not (res["status"] == "WORKING" and res["map_points"] > 0
            and launches["track"] > 0 and launches["remap"] > 0):
        raise AssertionError(f"demo failed: {rec}")
    return launches


def check_precision(system: EsvoSystem, cpu_rig: StereoRig,
                    cfg: SystemConfig) -> dict:
    """check_tracking_solve while the caller has set float32 matmul
    precision "high" (TF32): the port's guard runs the solve in full
    float32, so it must still agree with the CPU port (1e-4 m, 1e-4 rad),
    and the caller's "high" must hold afterwards. The script's own
    setting ("highest") is restored."""
    torch.set_float32_matmul_precision("high")
    try:
        res = check_tracking_solve(system, cpu_rig, cfg)
        after = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision("highest")
    res.update(compare="rpg tracking solve under the caller's "
               "float32 matmul precision 'high', card vs CPU port",
               caller_precision_after=after)
    if after != "high":
        raise AssertionError(f"the caller's precision came back as {after}")
    return res


# ---------------------------------------------------------------------------
# the event simulator, the backend and the accuracy campaign
# ---------------------------------------------------------------------------

# scripts/torch_sim_campaign.py's defaults: the room scene, 240x180, fx 200,
# baseline 0.1, contrast 0.10, 4 laps in 64 s, seed 42, 8192 events a
# substep of budget
CAMPAIGN = dict(width=240, height=180, fx=200.0, baseline=0.1, seed=42,
                duration=64.0, laps=4, contrast=0.10, budget=8192)
ESIM_PARITY_S = 0.25     # simulated seconds, card against the CPU port
ESIM_FULL_S = 1.0        # simulated seconds with the full sensor
# the campaign phase: the shortest of 8, 10 and 12 s at 2 laps in which
# the CPU port accepts a loop edge (8 s and 10 s: none; 12 s: 19, all
# true; the card: 19, all true, the same bytes every run since the
# backend's segment sums add in one fixed order). Its ATE bar, on the
# pose-graph keyframe chain (the campaign's optimized trajectory),
# calibrated on the CPU port at the same settings: 0.466-0.523 m over
# three thread counts (PERF.md section 4), a pose held at the start
# 0.695 m. The live trajectory's ATE is reported beside it, not gated: a
# fold-back moves the whole live trajectory with the world frame, so it
# changes that ATE only through the closed loop's chaos
CAMPAIGN_RUN = dict(duration=12.0, laps=2)
CAMPAIGN_ATE_BAR = 0.60
# tests/test_loop_closure_e2e.py's bound on an accepted edge's error (m)
LOOP_EDGE_BAR = 0.1


def campaign_K() -> np.ndarray:
    c = CAMPAIGN
    return np.array([[c["fx"], 0.0, c["width"] / 2 - 0.5],
                     [0.0, c["fx"], c["height"] / 2 - 0.5],
                     [0.0, 0.0, 1.0]])


def campaign_poses():
    """The left camera's loop trajectory and the right camera's."""
    pose = lambda t: esim.loop_trajectory_pose(
        t, CAMPAIGN["duration"], laps=CAMPAIGN["laps"])
    T_lr = np.eye(4)
    T_lr[0, 3] = CAMPAIGN["baseline"]
    return {"left": pose, "right": lambda t: pose(t) @ T_lr}


def event_match_share(a: EventArray, b: EventArray) -> float:
    """Share of the larger stream's events that the other holds too,
    equal in (x, y, p) with t on the same microsecond (a multiset
    intersection: one extra crossing shifts nothing)."""
    def keys(e):
        pix = (e.y.astype(np.int64) * CAMPAIGN["width"] + e.x) * 2 + e.p
        return (pix << 32) + np.round(e.t * 1e6).astype(np.int64)
    ua, ca = np.unique(keys(a), return_counts=True)
    ub, cb = np.unique(keys(b), return_counts=True)
    _, ia, ib = np.intersect1d(ua, ub, return_indices=True)
    return float(np.minimum(ca[ia], cb[ib]).sum()) / max(len(a), len(b), 1)


def esim_phase(card, device="cuda") -> dict:
    """The simulator on the room scene at the campaign's sensor: with
    --quick's sensor (noise off) ESIM_PARITY_S of each camera on the card
    and on the CPU port (counts within 0.5%, >= 99.5% of events equal,
    no overflow); with the full sensor (FPN, leak, 8 hot pixels)
    ESIM_FULL_S on the card: events/s, overflow, the hot pixels' rate
    (within 20% of 1 kHz), ms a simulated substep, peak memory."""
    c = CAMPAIGN
    scene = esim.make_room_scene(np.random.default_rng(c["seed"]))
    K, W, H = campaign_K(), c["width"], c["height"]
    quick = esim.SensorConfig(contrast_threshold=c["contrast"],
                              threshold_fpn_sigma=0.0,
                              background_rate_hz=0.0, num_hot_pixels=0,
                              event_budget_per_step=c["budget"])
    full = esim.SensorConfig(contrast_threshold=c["contrast"],
                             event_budget_per_step=c["budget"])
    res = dict(phase="esim", card=card, width=W, height=H,
               parity_s=ESIM_PARITY_S, full_s=ESIM_FULL_S, cameras={})
    failures = []
    torch.cuda.reset_peak_memory_stats()
    full_wall = 0.0
    for i, (cam, pose) in enumerate(campaign_poses().items()):
        runs = {}
        for dev in (device, "cpu"):
            t0 = _sync(dev)
            runs[dev] = esim.simulate_camera(
                scene, K, W, H, pose, 0.0, ESIM_PARITY_S, quick,
                np.random.default_rng([c["seed"], i]), device=dev)
            runs[dev + "_s"] = _sync(dev) - t0
        (ev, st), (ev_c, st_c) = runs[device], runs["cpu"]
        share = event_match_share(ev, ev_c)
        count_rel = abs(len(ev) - len(ev_c)) / max(len(ev_c), 1)
        t0 = _sync(device)
        evf, stf = esim.simulate_camera(
            scene, K, W, H, pose, 0.0, ESIM_FULL_S, full,
            np.random.default_rng([c["seed"], i]), device=device)
        wall = _sync(device) - t0
        full_wall += wall
        leak = esim._sensor_maps(full, W, H,
                                 np.random.default_rng([c["seed"], i]))[2]
        hot = np.flatnonzero(leak.reshape(-1) >= 1.0)
        pix = evf.y.astype(np.int64) * W + evf.x
        hot_hz = float(np.isin(pix, hot).sum()) / ESIM_FULL_S / len(hot)
        res["cameras"][cam] = dict(
            parity_events_card=len(ev), parity_events_cpu=len(ev_c),
            count_rel_diff=count_rel, match_share=share,
            overflow_card=st["overflow_dropped"],
            overflow_cpu=st_c["overflow_dropped"],
            parity_card_s=runs[device + "_s"], parity_cpu_s=runs["cpu_s"],
            full_events=len(evf), full_events_per_s=len(evf) / ESIM_FULL_S,
            full_overflow=stf["overflow_dropped"], hot_pixels=len(hot),
            hot_pixel_hz=hot_hz, full_wall_s=wall)
        if not (share >= 0.995 and count_rel <= 0.005
                and st["overflow_dropped"] == st_c["overflow_dropped"] == 0
                and 800.0 <= hot_hz <= 1200.0):
            failures.append(cam)
    n_sub = 2 * round(ESIM_FULL_S / full.substep_dt)
    res.update(ms_per_substep=full_wall * 1e3 / n_sub,
               wall_s_per_simulated_s=full_wall / ESIM_FULL_S,
               peak_memory_mb=torch.cuda.max_memory_allocated() / 2 ** 20)
    log(res)
    if failures:
        raise AssertionError(f"esim failed on {failures}: {res}")
    return res


def _rot3(w) -> np.ndarray:
    """Rotation matrix of an axis-angle 3-vector (float64)."""
    return so3_exp(torch.as_tensor(np.asarray(w, np.float64))).numpy()


def _pose_err(A: np.ndarray, B: np.ndarray) -> tuple[float, float]:
    """Largest translation (m) and rotation (rad) gap of two pose sets."""
    A, B = A.reshape(-1, 4, 4), B.reshape(-1, 4, 4)
    return (float(np.abs(A[:, :3, 3] - B[:, :3, 3]).max()),
            max(pose_angle(a[:3, :3], b[:3, :3]) for a, b in zip(A, B)))


def _keyframe_cloud(scene, T: np.ndarray, n: int, rng):
    """(edge image 0-255, the n strongest-edge pixels' camera-frame
    points) of the room scene at T, from its analytic render (as
    tests/test_loop_closure_aliasing.py builds a keyframe)."""
    K = campaign_K()
    logI, depth = esim.render_log_intensity(
        scene, torch.as_tensor(T, dtype=torch.float32), K,
        CAMPAIGN["width"], CAMPAIGN["height"])
    logI, depth = logI.numpy(), depth.numpy()
    g = np.abs(np.diff(logI, axis=1, prepend=logI[:, :1])) \
        + np.abs(np.diff(logI, axis=0, prepend=logI[:1]))
    ts = np.clip(g / (g.max() + 1e-9) * 255.0, 0, 255)
    ys, xs = np.unravel_index(np.argsort(g, axis=None)[::-1][:n], g.shape)
    z = depth[ys, xs]
    p = np.stack([(xs - K[0, 2]) / K[0, 0] * z, (ys - K[1, 2]) / K[1, 1] * z,
                  z], axis=1) + rng.normal(scale=0.004, size=(n, 3))
    return ts.astype(np.float32), p.astype(np.float32)


def drift_window(rng) -> KeyframeGraph:
    """A drifting 6-keyframe window (tests/test_backend_loop.py's
    test_ba_reduces_drift_ate), as BackendLoop associates it."""
    P = 400
    pts = np.stack([rng.uniform(-0.8, 0.8, P), rng.uniform(-0.6, 0.6, P),
                    rng.uniform(1.5, 3.0, P)], axis=1)
    graph = KeyframeGraph(fx=150.0, fy=150.0, cx=120.0, cy=90.0)
    for k in range(6):
        T = np.eye(4)
        T[:3, 3] = [0.06 * k, 0.01 * k, 0.0]
        Tinv = np.linalg.inv(T)
        pc = pts @ Tinv[:3, :3].T + Tinv[:3, 3]
        uv = 150.0 * pc[:, :2] / pc[:, 2:] + [120.0, 90.0]
        ok = (uv[:, 0] > 0) & (uv[:, 0] < 240) & (uv[:, 1] > 0) \
            & (uv[:, 1] < 180)
        D = np.eye(4)
        if k >= 2:
            D[:3, :3] = _rot3(0.004 * (k - 1) * np.array([0.5, -1, 0.7]))
            D[:3, 3] = 0.02 * (k - 1) * np.array([1.0, -0.5, 0.3])
        graph.add_keyframe(D @ T, pts, uv, ok)
    return graph


def circle_chain(rng, K: int = 64):
    """Ground truth and a drifting odometry estimate of K poses on a
    circle."""
    gt = np.tile(np.eye(4), (K, 1, 1))
    for k in range(K):
        a = 2 * np.pi * k / K
        gt[k, :3, :3] = _rot3([0.0, 0.0, a])
        gt[k, :3, 3] = [np.cos(a), np.sin(a), 0.0]
    est = [gt[0]]
    for k in range(K - 1):
        noise = se3_exp(torch.as_tensor(np.concatenate(
            [rng.normal(size=3) * 0.003, rng.normal(size=3) * 0.01]))).numpy()
        est.append(est[-1] @ np.linalg.inv(gt[k]) @ gt[k + 1] @ noise)
    return gt, np.stack(est)


def loop_graph(gt, est, dtype, dev, extra: int) -> pgr.PoseGraph:
    """The odometry chain of `est` with two loop edges from `gt` (extra
    >= 2 edge slots; the rest stay invalid)."""
    K = len(gt)
    g = pgr.odometry_graph(torch.as_tensor(est, dtype=dtype, device=dev),
                           extra_capacity=extra)
    g = pgr.add_edge(g, K - 1, K - 1, 0, np.linalg.inv(gt[-1]) @ gt[0],
                     200.0, 200.0)
    return pgr.add_edge(g, K, 40, 8, np.linalg.inv(gt[40]) @ gt[8],
                        150.0, 150.0)


def backend_cases():
    """The four backend functions, each as (name, run(device) -> result,
    compare(card, cpu) -> (ok, numbers)), on inputs made once on the
    host."""
    rng = np.random.default_rng(5)
    scene = esim.make_room_scene(np.random.default_rng(CAMPAIGN["seed"]))
    pose = campaign_poses()["left"]
    ts, cloud_a = _keyframe_cloud(scene, pose(3.0), 600, rng)
    _, cloud_b = _keyframe_cloud(scene, pose(3.1), 600, rng)
    T_a, T_b = pose(3.0), pose(3.1).copy()
    T_b[:3, 3] += [0.03, -0.02, 0.01]                 # a drifted guess

    def descriptor(dev):
        return lc.ts_descriptor(torch.as_tensor(ts, device=dev))

    def icp(dev):
        t = lambda a: torch.as_tensor(a, device=dev)
        ok = torch.ones(600, dtype=torch.bool, device=dev)
        return lc.verify_loop_icp(t(cloud_a), ok, t(cloud_b), ok, T_a, T_b,
                                  lc.LoopClosureConfig(), gap_s=10.0)

    graph = drift_window(rng)

    def ba(dev):
        prob = build_ba_problem(graph, max_points=2000, device=dev)
        return bundle_adjust(prob, BAConfig(max_iterations=8,
                                            num_fixed_poses=2))

    gt, est = circle_chain(rng)

    def posegraph(dev):
        return pgr.optimize_pose_graph(
            loop_graph(gt, est, F32, dev, extra=2),
            pgr.PoseGraphConfig(max_iterations=15, huber_threshold=10.0))

    def cmp_desc(a, b):
        err = float((a.cpu() - b).abs().max())
        return err <= 1e-5, dict(max_abs_err=err)

    def cmp_icp(a, b):
        et, er = _pose_err(a[1], b[1])
        return (a[0] == b[0] and et <= 1e-4 and er <= 1e-4), dict(
            accepted=a[0], cpu_accepted=b[0], max_t_err_m=et,
            max_R_err_rad=er, frac=a[2], cpu_frac=b[2])

    def cmp_ba(a, b):
        costs = a[1].cpu().double().numpy()
        et, er = _pose_err(a[0].T_world_kf.cpu().double().numpy(),
                           b[0].T_world_kf.double().numpy())
        ok = bool((np.diff(costs) <= 0).all()) and et <= 1e-4 and er <= 1e-4
        return ok, dict(cost_first=float(costs[0]),
                        cost_last=float(costs[-1]), max_t_err_m=et,
                        max_R_err_rad=er)

    def cmp_pg(a, b):
        et, er = _pose_err(a[0].T_world.cpu().double().numpy(),
                           b[0].T_world.double().numpy())
        c = a[1].cpu().double().numpy()
        return et <= 1e-4 and er <= 1e-4, dict(
            cost_first=float(c[0]), cost_last=float(c[-1]),
            max_t_err_m=et, max_R_err_rad=er)

    return [("ts_descriptor 180x240", descriptor, cmp_desc),
            ("verify_loop_icp 600 points", icp, cmp_icp),
            ("bundle_adjust 6 keyframes", ba, cmp_ba),
            ("optimize_pose_graph 64 poses", posegraph, cmp_pg)]


def _host_arrays(out) -> list:
    """Every tensor and array in a backend function's output, on the
    host, in a fixed order."""
    if torch.is_tensor(out):
        return [out.cpu().numpy()]
    if isinstance(out, np.ndarray):
        return [out]
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _host_arrays(o)]
    if dataclasses.is_dataclass(out):
        return [a for f in dataclasses.fields(out)
                for a in _host_arrays(getattr(out, f.name))]
    return []


def backend_parity_phase(card, device="cuda") -> None:
    """Each backend function on the card against the CPU port on the
    same inputs (1e-5 for the descriptor, 1e-4 m / rad for the poses,
    accept flags equal, BA costs non-increasing), also while the caller
    has set float32 matmul precision "high"; and the card's last timed
    run bit for bit its warm-up run (the segment sums add in one fixed
    order, so a closed loop with the backend repeats itself); ms on the
    card, median of 5 after a warm-up."""
    failures = []
    for name, run, compare in backend_cases():
        cpu = run("cpu")
        first = _host_arrays(run(device))
        times = []
        for _ in range(5):
            t0 = _sync(device)
            out = run(device)
            times.append((_sync(device) - t0) * 1e3)
        ok, nums = compare(out, cpu)
        last = _host_arrays(out)
        nums["repeats_bitwise"] = len(first) == len(last) and all(
            np.array_equal(a, b, equal_nan=True) for a, b in zip(first, last))
        ok = ok and nums["repeats_bitwise"]
        torch.set_float32_matmul_precision("high")
        try:
            ok_high, nums_high = compare(run(device), cpu)
        finally:
            torch.set_float32_matmul_precision("highest")
        log(dict(compare=f"{name}, card vs CPU port", card=card,
                 ms=float(np.median(times)), ms_all=times, ok=ok, **nums,
                 under_high=dict(ok=ok_high, **nums_high)))
        if not (ok and ok_high):
            failures.append(name)
    if failures:
        raise AssertionError(f"backend parity failed: {failures}")


class _Stopwatch:
    """Replaces module.name with a wrapper that adds each call's wall
    time, up to a synchronize, to `ms` (restored by close())."""

    def __init__(self, module, name: str, device="cuda"):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.ms: list[float] = []

        def timed_call(*a, **kw):
            t0 = _sync(device)
            try:
                return self.fn(*a, **kw)
            finally:
                self.ms.append((_sync(device) - t0) * 1e3)
        setattr(module, name, timed_call)

    def close(self) -> list[float]:
        setattr(self.module, self.name, self.fn)
        return self.ms


def backend_world(device="cuda"):
    """tests/test_loop_closure_e2e.py's world: a periodic synthetic scene
    (240x180, fx 150, 100 Hz ticks, one 0.5-s period, its seed and
    config)."""
    rng = np.random.default_rng(7)
    rig = make_ideal_rig(240, 180, 150.0, 150.0, 119.5, 89.5, 0.1,
                         device=device)
    scene = make_scene(rng, num_points=4000, duration=0.5, steps=51,
                       motion_scale=0.6)
    ev_l, ev_r = simulate_stereo_events(
        scene, rig.left.params.P.double().cpu().numpy(),
        rig.right.params.P.double().cpu().numpy(), 240, 180,
        pixel_threshold=0.75, rng=rng)
    ticks = np.arange(TICK, 0.5, TICK)
    frames = (frame_events(ev_l, ticks, 3000), frame_events(ev_r, ticks, 3000))
    cfg = SystemConfig.from_dict(dict(
        depth=dict(max_iteration=8), bm=dict(zncc_threshold=0.25),
        sgm=dict(num_disparities=48),
        mapping=dict(process_event_num=800, init_sgm_num_threshold=300,
                     std_var_vis_threshold=0.05, age_vis_threshold=0,
                     denoising=False, regularization=False)))
    return rig, scene, ticks, frames, cfg


def _backend_run(name, rig, scene, ticks, frames, cfg, card,
                 device="cuda") -> tuple:
    """One closed loop of the backend world with BackendLoop and
    PoseGraphLoop (the e2e test's detector) attached, driven as the e2e
    test drives it (a tick at a time, a mapping cycle every 5 ticks and
    on the last, where the period closes). "resident": the same, but
    after the bootstrap (rolls of 5 on the host path) the ticks run in
    ResidentLoop dispatches (rolls of 5, RESIDENT_R a dispatch) while a
    whole dispatch fits, and the last ticks on the host path again. One
    line, with the run's wall split; returns (its launches, its loop
    closures)."""
    pick = lambda f, sl: {k: v[sl] for k, v in f.items() if k != "dropped"}
    system = EsvoSystem(rig, cfg, device=device, seed=0)
    backend = BackendLoop(system, keyframe_every=2, window=6)
    pgl = PoseGraphLoop(system, keyframe_every=1,
                        lc_config=lc.LoopClosureConfig(min_gap=4,
                                                       min_similarity=0.88))
    watches = {"ba": _Stopwatch(backend_loop, "bundle_adjust", device),
               "icp": _Stopwatch(lc, "verify_loop_icp", device),
               "pose_graph": _Stopwatch(pgr, "optimize_pose_graph", device)}
    verified = []        # each ICP verification's gate values
    timed_icp = lc.verify_loop_icp

    def record_icp(*a, **kw):
        res = timed_icp(*a, **kw)
        verified.append(dict(accepted=res[0], **res[4]))
        return res
    lc.verify_loop_icp = record_icp
    reset_launches()
    loop, k, n, disp = None, 0, len(ticks), ROLL * RESIDENT_R
    resident = name == "resident"
    # the run's wall split: a resident run's rolls before its first
    # dispatch (the bootstrap), ResidentLoop.start plus the first dispatch
    # (its warm-up and capture), the later dispatches with their syncs,
    # the ticks a tick at a time (all of a host run's), and the backends'
    # maybe_update calls
    split = dict.fromkeys(("bootstrap", "start_and_capture", "dispatches",
                           "host_ticks", "backends"), 0.0)
    t_start = _sync(device)
    try:
        while k < n:
            t0 = _sync(device)
            if resident and system.status.value != "WORKING" \
                    and loop is None:
                sl = slice(k, k + ROLL)
                out = system.process_ticks(ticks[sl], pick(frames[0], sl),
                                           pick(frames[1], sl),
                                           do_mapping=True)
                k += ROLL
                part = "bootstrap"
            elif resident and k + disp <= n:
                part = "dispatches"
                if loop is None:
                    loop = ResidentLoop(system, ROLL, RESIDENT_R)
                    loop.start()
                    part = "start_and_capture"
                sl = slice(k, k + disp)
                loop.run(ticks[sl], pick(frames[0], sl), pick(frames[1], sl))
                out = loop.sync()
                k += disp
            else:
                if loop is not None:
                    loop.finish()
                    loop = None
                out = system.process_tick(float(ticks[k]), pick(frames[0], k),
                                          pick(frames[1], k),
                                          do_mapping=(k % 5 == 4
                                                      or k == n - 1))
                k += 1
                part = "host_ticks"
            t1 = _sync(device)
            split[part] += t1 - t0
            backend.maybe_update(out)
            pgl.maybe_update(out)
            split["backends"] += _sync(device) - t1
        system.flush()
        wall = _sync(device) - t_start
    finally:
        lc.verify_loop_icp = timed_icp
        ms = {key: w.close() for key, w in watches.items()}
    launches = launch_counts()
    t_est, T_est = system.trajectory()
    gt = np.stack([interpolate_gt_pose(scene, t) for t in t_est])
    pt, pT = pgl.optimized_trajectory()
    edges = []
    for ti, tj, T_edge in pgl.loop_edges():
        rel = np.linalg.inv(interpolate_gt_pose(scene, ti)) \
            @ interpolate_gt_pose(scene, tj)
        edges.append(float(np.linalg.norm(T_edge[:3, 3] - rel[:3, 3])))
    finite = bool(np.isfinite(T_est).all() and np.isfinite(pT).all())
    rec = dict(backend_loop=name, card=card, status=system.status.value,
               ticks=len(t_est), wall_s=wall, ticks_per_s=len(t_est) / wall,
               wall_split_s=split,
               ba_runs=backend.num_ba_runs,
               ba_rejected=backend.num_rejected_corrections,
               loop_closures=pgl.num_loop_closures,
               pose_graph_runs=pgl.num_optimizations,
               loop_edge_err_m=edges, loop_edge_bar_m=LOOP_EDGE_BAR,
               verified=verified,
               ba_ms=ms["ba"], icp_ms=ms["icp"], pose_graph_ms=ms["pose_graph"],
               ate_raw_m=ate_rmse(t_est, T_est, t_est, gt, align=True),
               ate_pose_graph_m=(ate_rmse(pt, pT, pt, np.stack(
                   [interpolate_gt_pose(scene, t) for t in pt]), align=True)
                   if len(pt) > 2 else None),
               finite=finite, launches=launches,
               launches_note=("counted by the kernel wrappers: a resident "
                              "run's ResidentLoop replays are not among "
                              "them")
               if resident else None)
    log(rec)
    if not (rec["status"] == "WORKING" and finite
            and all(e < LOOP_EDGE_BAR for e in edges)):
        raise AssertionError(f"backend loop ({name}) failed: {rec}")
    return launches, rec["loop_closures"]


def backend_loop_phase(card, device="cuda") -> dict:
    """The backend world on the host path and through the resident loop.
    Gates: each run WORKING with finite poses and every accepted edge
    within LOOP_EDGE_BAR of ground truth. The closures are reported with
    each ICP verification's gate values, not gated: whether the scene's
    one clean revisit registers is chaotic (a change of world frame of
    1e-6 m and rad after tick 10 flips it on the CPU port;
    scripts/torch_loop_closure_sensitivity.py, PERF.md section 4). The
    campaign phase gates on accepted loop edges. Returns {run:
    launches}."""
    world = backend_world(device)
    return {name: _backend_run(name, *world, card, device)[0]
            for name in ("host", "resident")}


def sim_campaign_phase(card, device="cuda") -> dict:
    """scripts/torch_sim_campaign.py --quick --resident 2 --ba at
    CAMPAIGN_RUN's duration and laps: simulation, the closed loop with
    both backends, and the scoring, on the card. Gates: it completes,
    WORKING, finite poses, the pose-graph chain's ATE under
    CAMPAIGN_ATE_BAR, at least one loop edge that classify_loop_edges
    finds true and none false. Returns its launches."""
    spec = importlib.util.spec_from_file_location(
        "torch_sim_campaign",
        Path(__file__).resolve().parent / "scripts" / "torch_sim_campaign.py")
    campaign = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(campaign)
    out = DATASET_DIR.parent / "chip_smoke_campaign"
    argv = ["--out", str(out), "--duration", str(CAMPAIGN_RUN["duration"]),
            "--laps", str(CAMPAIGN_RUN["laps"]), "--quick", "--resident", "2",
            "--ba", "--regen"]
    reset_launches()
    t0 = time.perf_counter()
    res = campaign.main(argv, device=device)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    _, T = load_tum(str(out / "trajectory.txt"))
    rec = dict(sim_campaign=argv, card=card, phase_wall_s=wall,
               finite=bool(np.isfinite(T).all()),
               ate_bar_m=CAMPAIGN_ATE_BAR, launches=launches,
               **{k: v for k, v in res.items() if k != "loop_edge_details"})
    log(rec)
    if not (res.get("status") == "WORKING" and rec["finite"]
            and res.get("pg_ate_rmse_m") is not None
            and res["pg_ate_rmse_m"] < CAMPAIGN_ATE_BAR
            and res.get("loop_edges_true", 0) >= 1
            and res.get("loop_edges_false", 0) == 0):
        raise AssertionError(f"sim campaign failed: {rec}")
    return launches


# ---------------------------------------------------------------------------
# the event-axis sharding (parallel/sharding.py) and the new mapping paths
# ---------------------------------------------------------------------------

SHARD_ROLLS = 5            # the sharded closed loop: 25 ticks, 5 cycles
SHARD_REG = dict(kernel_size=0, lm_damping=1e-3)   # tests/test_parallel.py
SHARD_BA_ITERS = 4
SHARD_PG_ITERS = 10


def _textured_pair(rng, W: int, H: int, disp: int):
    """A smooth random left surface and the right one shifted by `disp`
    pixels plus half an 8-bit level of noise (lm_world's pair)."""
    base = rng.uniform(0, 255, (H, W + 2 * disp + 64))
    k = np.ones(5) / 5
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    return (base[:, 32:32 + W].astype(np.float32),
            (base[:, 32 + disp:32 + disp + W]
             + rng.uniform(-0.5, 0.5, (H, W))).astype(np.float32))


def shard_worlds() -> dict:
    """tests/test_parallel.py's six cases at the port's real sizes, as
    numpy: a 240x180 surface update of one runner frame (4 x
    PROCESS_EVENT_NUM = 4000 events); the map estimate at rpg (N = 1000)
    and DSEC (N = 10000) with their presets; a tracking step of the rpg
    tracker's 2000 points; the BA normal equations and BA of
    drift_window; the 64-pose loop graph. BA and the pose graph in
    float64, as the JAX package's tests run them. Every axis a sharded
    function splits is even."""
    w = {}
    rng = np.random.default_rng(0)
    W, H, n = 240, 180, 4000
    w["surface"] = dict(W=W, H=H, x=rng.integers(0, W, n),
                        y=rng.integers(0, H, n),
                        t=np.sort(rng.uniform(0, 0.01, n)).astype(np.float32),
                        p=rng.random(n) > 0.5)
    for name, n, disp in (("rpg", 1000, 8), ("dsec", 10000, 20)):
        W, H = RIGS[name][:2]
        rng = np.random.default_rng(1)
        ts_l, ts_r = _textured_pair(rng, W, H, disp)
        x = np.stack([rng.uniform(30 + disp, W - 30, n),
                      rng.uniform(20, H - 20, n)], 1).astype(np.float32)
        T = se3_exp(torch.tensor(rng.normal(0, 2e-3, (n, 6)),
                                 dtype=F32)).numpy()
        w[f"map_{name}"] = dict(rig=name, ts_l=ts_l, ts_r=ts_r, x_rect=x,
                                t=np.sort(rng.uniform(0, 0.01, n)).astype(
                                    np.float32), valid=np.ones(n, bool), T=T)
    rng = np.random.default_rng(2)
    W, H, m = 240, 180, 2000
    w["tracking"] = dict(
        img=(0.7 * np.arange(W)[None, :] - 0.3 * np.arange(H)[:, None]
             + 100.0).astype(np.float32),
        pts=np.stack([rng.uniform(-0.5, 0.5, m), rng.uniform(-0.4, 0.4, m),
                      rng.uniform(1.0, 2.5, m)], 1).astype(np.float32))
    prob = build_ba_problem(drift_window(np.random.default_rng(6)),
                            max_points=2000, dtype=torch.float64,
                            device="cpu")
    pad = prob.obs_kf.shape[0] % 2
    grow = lambda a: torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
    w["ba"] = {f.name: getattr(prob, f.name).numpy() if f.name[:3] != "obs"
               else grow(getattr(prob, f.name)).numpy()
               for f in dataclasses.fields(prob)}
    gt, est = circle_chain(np.random.default_rng(12))
    g = loop_graph(gt, est, torch.float64, "cpu", extra=3)   # 66 edges
    w["pose_graph"] = {f.name: getattr(g, f.name).numpy()
                       for f in dataclasses.fields(g)}
    return w


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.tensor(a, dtype=dtype, device=device)


def case_surface(w, device, mesh=None):
    ev = tsf.EventBatch.from_arrays(w["x"], w["y"], w["t"], w["p"],
                                    device=device)
    state = tsf.init_state(w["H"], w["W"], device)
    st = (ps.sharded_surface_update(mesh, state, ev) if mesh is not None
          else tsf.insert_events(state, ev))
    return st.last_t_pos, st.last_t_neg


def case_map(w, device, mesh=None):
    rig = make_rig(w["rig"], device)
    preset = RPG if w["rig"] == "rpg" else DSEC
    bm_cfg = bm.BlockMatchConfig(**preset["bm"])
    dp_cfg = dr.DepthProblemConfig(**preset["depth"])
    args = [_t(w[k], device) for k in ("ts_l", "ts_r", "x_rect", "t",
                                       "valid", "T", "T")]
    if mesh is not None:
        return ps.sharded_map_estimate(mesh, rig, bm_cfg, dp_cfg)(*args)
    ts_l, ts_r, x, t, v, T, _ = args
    m = bm.match_events(ts_l, ts_r, x, x, t, v, rig.left.mask, rig, bm_cfg)
    return dr.solve(m.x_left, T, T, m.inv_depth, m.valid, t, ts_l, ts_r,
                    rig, dp_cfg)


@highest_precision()
def case_tracking(w, device, mesh=None):
    cam = make_rig("rpg", device).left
    cfg = reg.RegProblemConfig(**SHARD_REG)
    neg, gu, gv = reg.negative_time_surface(_t(w["img"], device), 0)
    R, t = torch.eye(3, device=device), torch.zeros(3, device=device)
    Twr = torch.eye(4, device=device)
    pts = _t(w["pts"], device)
    ok = torch.ones(pts.shape[0], dtype=torch.bool, device=device)
    if mesh is not None:
        return ps.sharded_tracking_step(mesh, cam, cfg)(R, t, Twr, neg, gu,
                                                        gv, pts, ok)
    prob = reg.RegProblem(R=R, t=t, T_world_ref=Twr, points=pts,
                          point_valid=ok, ts_negative=neg, grad_u=gu,
                          grad_v=gv)
    fvec, _, _ = reg.residuals_and_weights(
        prob, torch.zeros(6, device=device), pts, ok, cam, cfg)
    J = reg.analytic_jacobian(prob, pts, ok, cam, cfg)
    f = fvec.reshape(-1)
    Hm = torch.matmul(J.T, J)
    damp = cfg.lm_damping * torch.diag(torch.diag(Hm)) \
        + 1e-12 * torch.eye(6, device=device)
    dx = -solve_spd(Hm + damp, torch.matmul(J.T, f))
    return torch.where(torch.isfinite(dx), dx, 0.0), torch.sum(f * f)


def _ba_problem(w, device) -> BAProblem:
    return BAProblem(**{k: _t(v, device) for k, v in w.items()})


def case_ba_blocks(w, device, mesh=None):
    prob = _ba_problem(w, device)
    if mesh is None:
        return assemble_normal_equations(prob, BAConfig())[:4]
    return ps.sharded_ba_normal_equations(mesh, BAConfig())(
        prob.T_world_kf, prob.points, prob.obs_kf, prob.obs_point,
        prob.obs_uv, prob.obs_valid, prob.fx, prob.fy, prob.cx, prob.cy)


def case_ba(w, device, mesh=None):
    prob = _ba_problem(w, device)
    cfg = BAConfig(max_iterations=SHARD_BA_ITERS)
    res, costs = (ps.sharded_bundle_adjust(mesh, cfg)(prob)
                  if mesh is not None else bundle_adjust(prob, cfg))
    return res.T_world_kf, res.points, costs


def case_pose_graph(w, device, mesh=None):
    graph = pgr.PoseGraph(**{k: _t(v, device) for k, v in w.items()})
    cfg = pgr.PoseGraphConfig(max_iterations=SHARD_PG_ITERS)
    res, costs = (ps.sharded_pose_graph(mesh, cfg)(graph)
                  if mesh is not None
                  else pgr.optimize_pose_graph(graph, cfg))
    return res.T_world, costs


# case -> (its function, its world in shard_worlds)
SHARD_CASES = {"surface": (case_surface, "surface"),
               "map_rpg": (case_map, "map_rpg"),
               "map_dsec": (case_map, "map_dsec"),
               "tracking": (case_tracking, "tracking"),
               "ba_blocks": (case_ba_blocks, "ba"),
               "ba": (case_ba, "ba"),
               "pose_graph": (case_pose_graph, "pose_graph")}


def shard_cases(worlds: dict, device, mesh=None) -> dict:
    """Every case through its sharded function (with a mesh) or the
    unsharded call (without)."""
    return {case: fn(worlds[world], device, mesh)
            for case, (fn, world) in SHARD_CASES.items()}


def shard_some(worlds: dict, cases, device) -> dict:
    """Rank body of tests/test_torch_cuda.py: the named cases through
    their sharded functions on the mesh of all ranks."""
    mesh = ps.make_mesh()
    return {case: SHARD_CASES[case][0](worlds[SHARD_CASES[case][1]], device,
                                       mesh) for case in cases}


def shard_loop(rolls, device, mesh) -> dict:
    """EsvoSystem(mesh=...) over the closed-loop phase's first SHARD_ROLLS
    rolls (same stream, preset and point-selection seed). Returns the
    trajectory and the status."""
    system = EsvoSystem(make_rig("rpg", device), SystemConfig.from_dict(RPG),
                        mesh=mesh, device=device, seed=0)
    for t_r, ev_l, ev_r in rolls:
        system.process_ticks(t_r, ev_l, ev_r)
    t_est, T_est = system.trajectory()
    return dict(t=np.asarray(t_est), T=np.asarray(T_est),
                status=system.status.value,
                map_points=system.stats["map_points"])


def shard_rank(worlds: dict, rolls, device) -> dict:
    """One rank of the sharded phase: every case once through its sharded
    function and the sharded closed loop, with the K1-K7 launches that
    run made (counted from 0); then, on a one-rank mesh, ms a sharded
    call against the unsharded one in this same process."""
    mesh = ps.make_mesh()
    reset_launches()
    cases = shard_cases(worlds, device, mesh)
    loop = shard_loop(rolls, device, mesh)
    _sync(device)
    launches = launch_counts()
    ms = {}
    if mesh.size() == 1 and device.type == "cuda":
        for case in ("surface", "map_rpg", "map_dsec", "tracking"):
            fn, world = SHARD_CASES[case]
            w = worlds[world]
            ms[case] = dict(
                sharded_ms=cuda_ms(lambda: fn(w, device, mesh), 5, warmup=1),
                unsharded_ms=cuda_ms(lambda: fn(w, device), 5, warmup=1))
    return dict(cases=cases, loop=loop, launches=launches, ms=ms,
                backend=dist.get_backend(), rank=dist.get_rank())


def _max_diff(a: list, b: list) -> float:
    """Largest absolute difference over two outputs (_host_arrays), NaN
    where their shapes differ (NaN lanes are left out: _bitwise sees
    them)."""
    if any(x.shape != y.shape for x, y in zip(a, b)):
        return math.nan
    return max((float(np.nanmax(np.abs(x.astype(np.float64)
                                       - y.astype(np.float64)), initial=0))
                for x, y in zip(a, b) if x.size), default=0.0)


def _bitwise(a: list, b: list) -> bool:
    """Two outputs (_host_arrays) with the same bits, NaN payloads and
    signed zeros included."""
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and x.tobytes() == y.tobytes() for x, y in zip(a, b))


def _close(x, y, rtol, atol) -> bool:
    return bool(np.allclose(x, y, rtol=rtol, atol=atol))


def shard_within_tol(case: str, got: list, want: list) -> bool:
    """tests/test_parallel.py's tolerances of a sharded call against the
    unsharded one: surfaces exact; map estimate validity exact and
    inverse depth rtol 1e-5 / atol 1e-7; tracking cost rtol 1e-5 and dx
    rtol 0.1 / atol 1e-3; BA blocks rtol 1e-6 / atol 1e-8; BA and pose
    graph costs rtol 1e-5, poses rtol 1e-4 / atol 1e-6, points rtol 1e-4
    / atol 1e-5."""
    if case == "surface":
        return _bitwise(got, want)
    if case.startswith("map_"):
        names = [f.name for f in dataclasses.fields(dr.DepthEstimates)]
        g, w = dict(zip(names, got)), dict(zip(names, want))
        return (np.array_equal(g["valid"], w["valid"])
                and _close(g["inv_depth"], w["inv_depth"], 1e-5, 1e-7))
    if case == "tracking":
        return (_close(got[1], want[1], 1e-5, 0.0)
                and _close(got[0], want[0], 0.1, 1e-3))
    if case == "ba_blocks":
        return all(_close(g, w, 1e-6, 1e-8) for g, w in zip(got, want))
    if case == "ba":
        return (_close(got[2], want[2], 1e-5, 0.0)
                and _close(got[0], want[0], 1e-4, 1e-6)
                and _close(got[1], want[1], 1e-4, 1e-5))
    return (_close(got[1], want[1], 1e-5, 0.0)
            and _close(got[0], want[0], 1e-4, 1e-6))


def sharded_phase(card, scene, ticks, frames, host_traj,
                  device="cuda") -> dict:
    """The event-axis sharding on the card. World 1 on NCCL (one spawned
    rank, so this process keeps no process group): every case and the
    closed loop's first SHARD_ROLLS rolls equal the unsharded calls on
    the card bit for bit (a collective over one rank is the identity).
    World 2 on gloo over CUDA tensors, both ranks on this card: each case
    within tests/test_parallel.py's tolerances of the unsharded call, the
    outputs the ranks replicate equal bit for bit, the closed loop's ATE
    under its bar. Returns the K1-K7 launches of both worlds' sharded
    runs, summed over their ranks."""
    worlds = shard_worlds()
    rolls = [_roll_inputs(frames, ticks, r * ROLL)
             for r in range(SHARD_ROLLS)]
    ref = {case: _host_arrays(out)
           for case, out in shard_cases(worlds, device).items()}
    n = SHARD_ROLLS * ROLL
    t_host, T_host = host_traj[0][:n], host_traj[1][:n]
    launches = {k: 0 for k in KERNELS}
    failures = []
    nccl = "nccl" if torch.device(device).type == "cuda" else "gloo"
    for world, backend in ((1, nccl), (2, "gloo")):
        t0 = time.perf_counter()
        res = ps.spawn_ranks(shard_rank, world, worlds, rolls,
                             device=device, backend=backend)
        wall = time.perf_counter() - t0
        per_rank = [r["launches"] for r in res]
        for k in launches:
            launches[k] += sum(r[k] for r in per_rank)
        for case in SHARD_CASES:
            got = _host_arrays(res[0]["cases"][case])
            exact = _bitwise(got, ref[case])
            rec = dict(sharded=case, world=world, backend=res[0]["backend"],
                       card=card, bitwise=exact,
                       max_abs_diff=_max_diff(got, ref[case]))
            if world == 1:
                ok = exact
            else:
                rec["within_tol"] = shard_within_tol(case, got, ref[case])
                rec["ranks_bitwise"] = all(
                    _bitwise(_host_arrays(r["cases"][case]), got)
                    for r in res[1:])
                ok = rec["within_tol"] and rec["ranks_bitwise"]
            log(rec)
            if not ok:
                failures.append((world, case))
        loop = res[0]["loop"]
        gt = np.stack([interpolate_gt_pose(scene, t) for t in loop["t"]])
        ate = ate_rmse(loop["t"], loop["T"], loop["t"], gt, align=True)
        same_t = np.array_equal(loop["t"], t_host)
        rec = dict(sharded_loop="rpg", world=world,
                   backend=res[0]["backend"], card=card, ticks=len(loop["t"]),
                   status=loop["status"], map_points=loop["map_points"],
                   ate_m=ate, ate_bar_m=CLOSED_LOOP_ATE_BAR,
                   host_path_bitwise=same_t and np.array_equal(loop["T"],
                                                               T_host),
                   host_path_max_diff=float(np.abs(loop["T"] - T_host).max())
                   if same_t else math.nan,
                   ranks_bitwise=all(np.array_equal(r["loop"]["T"], loop["T"])
                                     for r in res[1:]),
                   launches_per_rank=per_rank, phase_wall_s=wall)
        log(rec)
        if not (rec["status"] == "WORKING" and ate < CLOSED_LOOP_ATE_BAR
                and rec["ranks_bitwise"]
                and (world > 1 or rec["host_path_bitwise"])):
            failures.append((world, "closed loop"))
        if world == 1:
            log(dict(sharded_vs_unsharded_ms=res[0]["ms"], world=1,
                     backend=res[0]["backend"], card=card))
    log(dict(sharded_launches=launches, card=card))
    if failures or min(launches.values()) == 0:
        raise AssertionError(f"sharded phase failed: {failures}, "
                             f"launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# the headline benchmark (scripts/torch_bench.py)
# ---------------------------------------------------------------------------

# torch_bench.run's two pipeline shapes, in its order (both worlds come
# from one generator seeded 0): W, H, N, texture shift, block matching
BENCH_SHAPES = {
    "rpg": (240, 180, 4096, 8, bm.BlockMatchConfig()),
    "dsec": (640, 480, 8192, 24,
             bm.BlockMatchConfig(min_disparity=0, max_disparity=150)),
}


# K1 and K2 checked at the bench's kernel shapes: (windows, texture shift)
BENCH_KERNEL_SHAPES = {"bench_rpg": (4096, 8), "bench_dsec": (8192, 24)}


def _bench_config() -> SystemConfig:
    """The bench's depth problem (the K1 / K2 checks read only `depth`)."""
    return SystemConfig(depth=dr.DepthProblemConfig(max_iteration=10))


def bench_cycle(name: str, rng, device) -> dict:
    """One mapping cycle of torch_bench's world `name` (its build_cycle's
    stages, in the cycle's order, from an empty history), and on the card
    a profile of one more cycle (idle share)."""
    W, H, N, disp, bm_cfg = BENCH_SHAPES[name]
    rig, tex_l, tex_r, x, y, t, p = tb.make_world(W, H, N, disp, rng, device)
    cycle, st_ts, st_bm, st_solve, st_fuse, empty = tb.build_cycle(
        rig, W, H, N, 4, bm_cfg, _bench_config().depth, fu.FusionConfig(),
        tsf.TimeSurfaceConfig(), tex_l, tex_r)
    v = torch.ones(N, dtype=torch.bool, device=device)
    ts0 = tsf.init_state(H, W, device)
    _, ts_l = st_ts(ts0, x, y, t, p, v)
    m = st_bm(ts_l, x, y, t, v)
    est = st_solve(ts_l, m, t)
    _, inv_d, nfused = st_fuse(empty(), 0, est)
    out = dict(ts_l=ts_l, matches=m, est=est, inv_d=inv_d,
               nfused=int(nfused), fuse=st_fuse, empty=empty)
    if torch.device(device).type == "cuda":
        out["profile"] = _profiled(
            lambda: cycle(ts0, empty(), 0, x, y, t, p, v))
    return out


def _uncull(est: dr.DepthEstimates, m) -> dr.DepthEstimates:
    """The solve's estimates with the culling undone: bench.py's world
    culls every one (its left surface is the render blended with the
    texture, the right one the texture alone, so every residual exceeds
    the culling bound), and fusing nothing would hold nothing."""
    return est.replace(valid=m.valid & (est.inv_depth > 1e-3))


def compare_bench_cycle(name: str, card: dict, cpu: dict) -> dict:
    """The card's cycle against the CPU port's on the same world:
    surfaces within half an 8-bit level (the blend halves one) and 1e-4
    on >= 99.9% of the pixels; block matching's validity and disparity on
    >= 99% (tests/test_torch_block_matching.py); the solve's validity on
    >= 98% and its inverse depth at the LM tolerance (rtol 2e-4, atol
    2e-5) on >= 98% of the events matched on both sides (tests/
    test_torch_lm.py); the fused grid's occupancy on >= 98% of the pixels
    and nfused within 2%; then the fuse stage on the card's estimates
    with the culling undone, card against CPU: occupancy on >= 99%, the
    inverse depth within rtol 1e-4 on >= 99% of the pixels occupied on
    both, nfused within 1%."""
    h = lambda a: a.detach().cpu()
    ds = (h(card["ts_l"]) - cpu["ts_l"]).abs()
    mc, mh = card["matches"], cpu["matches"]
    bm_valid = float((h(mc.valid) == mh.valid).float().mean())
    both_m = h(mc.valid) & mh.valid
    disp_eq = float((h(mc.disparity)[both_m] == mh.disparity[both_m])
                    .float().mean())
    ec, eh = card["est"], cpu["est"]
    est_valid = float((h(ec.valid) == eh.valid).float().mean())
    d_close = float(torch.isclose(h(ec.inv_depth)[both_m],
                                  eh.inv_depth[both_m], rtol=2e-4,
                                  atol=2e-5).float().mean())
    occ_c, occ_h = h(card["inv_d"]) > 0, cpu["inv_d"] > 0
    grid_occ = float((occ_c == occ_h).float().mean())
    # the fuse stage alone on the card's uncull'ed estimates
    est_u = _uncull(ec, mc)
    _, inv_fc, nf_fc = card["fuse"](card["empty"](), 0, est_u)
    _, inv_fh, nf_fh = cpu["fuse"](cpu["empty"](), 0, est_u.map(h))
    oc, oh = h(inv_fc) > 0, inv_fh > 0
    both = oc & oh
    fuse_close = float(torch.isclose(h(inv_fc)[both], inv_fh[both],
                                     rtol=1e-4, atol=0).float().mean())
    nf_fc, nf_fh = int(nf_fc), int(nf_fh)
    res = dict(
        compare=f"bench {name} cycle, card vs CPU port",
        surface_max_abs_err=float(ds.max()),
        surface_close_share=float((ds <= 1e-4).float().mean()),
        bm_validity_agreement=bm_valid, bm_matched=int(both_m.sum()),
        bm_disparity_equal=disp_eq,
        solve_validity_agreement=est_valid,
        solve_valid_after_culling=[int(ec.valid.sum()), int(eh.valid.sum())],
        solve_inv_depth_within_lm_tol=d_close,
        solve_inv_depth_max_abs_err=float(
            (h(ec.inv_depth)[both_m] - eh.inv_depth[both_m]).abs().max()),
        cycle_grid_occupancy_agreement=grid_occ,
        cycle_nfused=[card["nfused"], cpu["nfused"]],
        uncull_estimates=int(est_u.valid.sum()),
        uncull_fused_pixels=[int(oc.sum()), int(oh.sum())],
        uncull_occupancy_agreement=float((oc == oh).float().mean()),
        uncull_inv_depth_close_share=fuse_close,
        uncull_nfused=[nf_fc, nf_fh])
    ok = (float(ds.max()) <= 0.5 + 1e-4
          and res["surface_close_share"] >= 0.999
          and bm_valid >= 0.99 and disp_eq >= 0.99 and est_valid >= 0.98
          and d_close >= 0.98 and grid_occ >= 0.98
          and abs(card["nfused"] - cpu["nfused"]) <= 0.02 * cpu["nfused"]
          and res["uncull_occupancy_agreement"] >= 0.99 and both.any()
          and fuse_close >= 0.99 and abs(nf_fc - nf_fh) <= 0.01 * nf_fh)
    if not ok:
        raise AssertionError(f"bench {name}: card and CPU cycles disagree: "
                             f"{res}")
    return res


def bench_phase(card) -> dict:
    """scripts/torch_bench.py on the card at bench.py's widths: its JSON
    line (the rpg and DSEC pipelines, the closed loop swept over 5 / 10 /
    25 / 50-tick resident dispatches and the host roll path), K1-K7
    launched in that run, each dispatch size's warm-up and capture ms,
    the closed loop gated (WORKING, finite poses, ATE under
    BENCH_ATE_BAR), and the rpg and DSEC cycles against the CPU port on
    the same worlds, with a profile of each card cycle. Returns the
    launches."""
    loops = []

    def recorded(*a, **kw):
        loop = ResidentLoop(*a, **kw)
        loops.append(loop)
        return loop

    reset_launches()
    tb.ResidentLoop = recorded
    try:
        line = tb.run("cuda")
    finally:
        tb.ResidentLoop = ResidentLoop
    launches = launch_counts()
    log(line)
    system = line["system"]
    log(dict(bench_closed_loop=card, launches=launches,
             ate_bar_m=BENCH_ATE_BAR,
             first_dispatch={l.K * l.R: dict(warmup_ms=l.warmup_ms,
                                             capture_ms=l.capture_ms)
                             for l in loops}))
    ates = system["ate_by_dispatch"]
    if not (set(ates) == {5, 10, 25, 50}
            and all(math.isfinite(a) and a < BENCH_ATE_BAR
                    for a in ates.values())
            and min(system["by_dispatch_ticks"].values()) > 0
            and min(launches[k] for k in UNREGULARIZED_KERNELS) > 0):
        raise AssertionError(f"bench closed loop failed: {system}, "
                             f"launches {launches}")
    rngs = {"cuda": np.random.default_rng(0), "cpu": np.random.default_rng(0)}
    for name in BENCH_SHAPES:       # run's order: the rpg world first
        card_out = bench_cycle(name, rngs["cuda"], "cuda")
        cpu_out = bench_cycle(name, rngs["cpu"], "cpu")
        log(dict(bench_cycle_profile=name, card=card, **card_out["profile"]))
        log(dict(compare_bench_cycle(name, card_out, cpu_out), card=card))
    return launches


def new_paths_phase(card, device="cuda") -> None:
    """The depth LM's scan (lm_kernel="xla", the zncc norm, the unwindowed
    solve) and block matching's "matmul" volume on the card at rpg (N =
    1000), each against the CPU port on the same inputs at the CPU
    tests' tolerances (tests/test_torch_lm.py: validity and inverse depth
    rtol 2e-4 / atol 2e-5 on >= 98% of events; tests/
    test_torch_block_matching.py: validity and disparity on >= 99%, cost
    atol 2e-4), with ms beside K2's path and the "slice" strategy, which
    the card runs as kernel K6."""
    cfg = SystemConfig.from_dict(RPG)
    rigs = {"card": make_rig("rpg", device), "cpu": make_rig("rpg", "cpu")}
    rng = np.random.default_rng(7)
    n, disp = 1000, 8
    ts_l, ts_r = _textured_pair(rng, 240, 180, disp)
    f = float(rigs["cpu"].left.params.P[0, 0])
    x = np.stack([rng.uniform(30 + disp, 210, n), rng.uniform(20, 160, n)],
                 1).astype(np.float32)
    d_init = (disp / (f * float(rigs["cpu"].baseline))
              * rng.uniform(0.85, 1.15, n)).astype(np.float32)
    T = se3_exp(torch.tensor(rng.normal(0, 2e-3, (n, 6)), dtype=F32)).numpy()
    inputs = {}
    for name, rig in rigs.items():
        dev = rig.left.lut.device
        inputs[name] = ([_t(a, dev) for a in (x, T, T, d_init)]
                        + [torch.ones(n, dtype=torch.bool, device=dev),
                           torch.zeros(n, device=dev), _t(ts_l, dev),
                           _t(ts_r, dev)])
    failures = []
    for name, kw in (("K2", {}), ("xla scan", dict(lm_kernel="xla")),
                     ("zncc scan", dict(ls_norm="zncc")),
                     ("unwindowed scan", dict(window_margin=-1))):
        dcfg = dataclasses.replace(cfg.depth, **kw)
        run = {k: (lambda k=k: dr.solve(*inputs[k], rigs[k], dcfg))
               for k in rigs}
        a, b = run["card"](), run["cpu"]()
        va, vb = a.valid.cpu().numpy(), b.valid.numpy()
        both = va & vb
        close = np.isclose(a.inv_depth.cpu().numpy()[both],
                           b.inv_depth.numpy()[both], rtol=2e-4, atol=2e-5)
        rec = dict(mapping_path=f"depth LM {name}", card=card, n=n,
                   valid=int(va.sum()), validity_agree=float((va == vb).mean()),
                   inv_depth_within=float(close.mean()),
                   ms=cuda_ms(run["card"], 10, warmup=2))
        log(rec)
        if not (both.sum() > 0.5 * n and rec["validity_agree"] > 0.98
                and rec["inv_depth_within"] >= 0.98):
            failures.append(name)
    want = None
    for strategy in ("slice", "matmul"):
        bcfg = dataclasses.replace(cfg.bm, cost_strategy=strategy)
        run = {k: (lambda k=k: bm.match_events(
            inputs[k][6], inputs[k][7], inputs[k][0], inputs[k][0],
            inputs[k][5], inputs[k][4], rigs[k].left.mask, rigs[k], bcfg))
            for k in rigs}
        a = run["card"]()
        if want is None:
            want = run["cpu"]()     # the CPU port's "slice": the reference
        va, vb = a.valid.cpu().numpy(), want.valid.numpy()
        both = va & vb
        rec = dict(mapping_path=f"block matching {strategy}", card=card, n=n,
                   matched=int(va.sum()),
                   validity_agree=float((va == vb).mean()),
                   disparity_equal=float((a.disparity.cpu().numpy()[both]
                                          == want.disparity.numpy()[both])
                                         .mean()),
                   cost_max_abs_diff=float(np.abs(
                       a.cost.cpu().numpy()[both]
                       - want.cost.numpy()[both]).max()),
                   ms=cuda_ms(run["card"], 10, warmup=2))
        log(rec)
        if not (both.sum() > 0.5 * n and rec["validity_agree"] >= 0.99
                and rec["disparity_equal"] >= 0.99
                and rec["cost_max_abs_diff"] <= 2e-4):
            failures.append(strategy)
    if failures:
        raise AssertionError(f"new mapping paths differ from the CPU port: "
                             f"{failures}")


# ---------------------------------------------------------------------------

KERNELS = {
    "remap": dict(name="K3 remap", module=remap,
                  source="esvo_tpu_torch/csrc/remap.cu",
                  replaces="esvo_tpu/ops/pallas_remap.py:122"),
    "patches": dict(name="K1 slice_patches", module=patches,
                    source="esvo_tpu_torch/csrc/patches.cu",
                    replaces="esvo_tpu/ops/pallas_patches.py:23"),
    "lm": dict(name="K2 lm_solve", module=lm,
               source="esvo_tpu_torch/csrc/lm.cu",
               replaces="esvo_tpu/ops/pallas_lm.py:57"),
    # port-only kernels: each replaces a fused XLA scan, not a Pallas one
    "track": dict(name="K4 track_solve", module=track,
                  source="esvo_tpu_torch/csrc/track.cu",
                  replaces="esvo_tpu/tracking/registration.py:283"),
    "regularize": dict(name="K5 regularize", module=regularize_op,
                       source="esvo_tpu_torch/csrc/regularize.cu",
                       replaces="esvo_tpu/mapping/regularization.py:56"),
    "bm": dict(name="K6 block_match", module=block_match_op,
               source="esvo_tpu_torch/csrc/block_match.cu",
               replaces="esvo_tpu/mapping/block_matching.py:151"),
    "fuse": dict(name="K7 fuse", module=fuse_op,
                 source="esvo_tpu_torch/csrc/fuse.cu",
                 replaces="esvo_tpu/mapping/fusion.py:242"),
}
# the kernels a MappingCycle launches (every one but the tracker's K4)
# and those of a loop without regularization (every one but K5)
CYCLE_KERNELS = ("remap", "patches", "lm", "regularize", "bm", "fuse")
UNREGULARIZED_KERNELS = ("remap", "patches", "lm", "track", "bm", "fuse")


def reset_launches() -> None:
    for info in KERNELS.values():
        info["module"].KERNEL.launches = info["module"].KERNEL.replayed = 0


def launch_counts() -> dict:
    """Each kernel's launches since reset_launches(): the host's calls
    and the launches inside the live WORKING cycle's and the live tick's
    graph replays (``CudaKernel.replayed``). ResidentLoop's replays are
    not among them: they are counted from the profiler's kernel
    records."""
    return {k: info["module"].KERNEL.launches
            + info["module"].KERNEL.replayed for k, info in KERNELS.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    # every float32 product in full float32 (PyTorch's defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()}; nvidia-smi: {card}")

    t0 = time.perf_counter()
    _build.build([info["source"].rsplit("/", 1)[1]
                  for info in KERNELS.values()])
    log(dict(build_s=time.perf_counter() - t0))
    for src, text in _build.BUILD_LOG.items():
        for fn, rep in ptxas_report(text).items():
            if not fn.startswith("slice_patches_kernel<"):   # see k1_launch
                log(f"ptxas {src} {fn}: {rep}")

    cfgs = {name: SystemConfig.from_dict(d)
            for name, d in (("rpg", RPG), ("dsec", DSEC))}
    rigs = {name: make_rig(name, "cuda") for name in RIGS}
    shapes = {"rpg": dict(n=1000, disp=8), "dsec": dict(n=10000, disp=40)}
    checks = {}
    for shape, s in shapes.items():
        rig = rigs[shape]
        checks[("remap", shape)] = check_remap(rig)
        checks[("patches", shape)] = check_patches(rig, s["n"])
        checks[("lm", shape)] = check_lm(rig, cfgs[shape], s["n"], s["disp"])
        checks[("track", shape)] = check_track(rig)
        checks[("regularize", shape)] = check_regularize(
            rig.left.height, rig.left.width, cfgs[shape].regularizer,
            iters=50 if shape == "rpg" else 20)
        # 100 launches: over 20 at DSEC the profiler recorded K6 / K7
        # 0.6-0.75x the device time that 50-100 give
        checks[("bm", shape)] = check_block_match(rig, cfgs[shape], s["n"],
                                                  s["disp"], iters=100)
        checks[("fuse", shape)] = check_fuse(rig, cfgs[shape], 4 * s["n"],
                                             iters=100)
        for k in KERNELS:
            log(dict(check=KERNELS[k]["name"], shape=shape, card=card,
                     **checks[(k, shape)]))
            if (k, shape) == ("remap", "rpg"):
                floor = launch_floor()
                log(dict(floor, card=card))

    streams = {name: make_stream(name, rigs[name]) for name in RIGS}
    launches = {}
    records = {}
    for name in ("rpg", "dsec"):
        reset_launches()
        scene, ticks, frames = streams[name]
        records[name] = run_cycle(name, rigs[name], cfgs[name], scene,
                                  ticks[:SCENES[name]["cycle_ticks"]], frames,
                                  "cuda")
        launches[name] = launch_counts()
        for rec in records[name]:
            log(dict(_public(rec), card=card))
        profile = [r for r in records[name] if "profile" in r][0]["profile"]
        records[name] = [r for r in records[name] if "profile" not in r]
        log(dict(slice=name, launches=launches[name]))
        if min(launches[name][k] for k in CYCLE_KERNELS) == 0:
            raise AssertionError(f"{name}: a kernel never launched: "
                                 f"{launches[name]}")
        if profile["cycle"]["rank_scans"]:
            raise AssertionError(f"{name}: the profiled cycle ran "
                                 f"{RANK_SCAN}: {profile['cycle']}")
    for name, recs in records.items():
        errs = [r["gt_median_rel_err"] for r in recs]
        if not (all(r["valid"] > 0 for r in recs)
                and np.nanmax(errs) < 0.3):
            raise AssertionError(f"{name}: no valid estimates or GT error "
                                 f"{errs}")

    cpu_rig = convert.rig_from_numpy(convert.rig_to_numpy(rigs["rpg"]),
                                     device="cpu")
    scene, ticks, frames = streams["rpg"]
    ref = run_cycle("rpg", cpu_rig, cfgs["rpg"], scene,
                    ticks[:SCENES["rpg"]["cycle_ticks"]], frames, "cpu")
    log(compare_to_cpu(records["rpg"], ref))
    log(dict(regularize_dispatch(records["rpg"], scene, ticks, cfgs["rpg"]),
             card=card))

    reset_launches()
    tracer.enable()
    try:
        loop = run_closed_loop(rigs["rpg"], cfgs["rpg"], scene, ticks,
                               frames, "cuda")
        cycles = tracer.take()["counters"]
    finally:
        tracer.disable()
    launches["closed_loop"] = launch_counts()
    system = loop["system"]
    tracked = [r for r in loop["rolls"] if r["lm_stats"] is not None]
    # the same stream one tick at a time: every live tick one replay of
    # the tick's graph (its render and, tracked, its tracking)
    live = run_live_ticks(rigs["rpg"], cfgs["rpg"], ticks, frames, "cuda")
    live_counts = {k: live["counters"].get(k, 0) for k in (
        "tick.replays", "tick.eager", "graph.captures", "cycle.replays")}
    live_ms = np.asarray(live["walls"])[np.asarray(live["tracked"])]
    summary = dict(
        closed_loop="rpg", card=card, status=system.status.value,
        ticks=loop["ticks"], tracked_rolls=len(tracked),
        ate_m=loop["ate"], ate_bar_m=CLOSED_LOOP_ATE_BAR,
        static_pose_ate_m=loop["static_ate"],
        tracking_rejects=system.stats["tracking_rejects"],
        launches=launches["closed_loop"],
        working_cycles={k: cycles.get(k, 0) for k in (
            "cycle.replays", "cycle.eager", "graph.captures")},
        sgm_bootstrap_ms=loop["stage_ms"][0],
        ms_per_tracked_tick=[r["ms_per_tick"] for r in tracked],
        mapping_ms=[r["mapping_ms"] for r in tracked],
        live_ticks=dict(live_counts, ticks=len(live["walls"]),
                        status=live["system"].status.value,
                        tick_graphs=len(live["system"]._ticks),
                        tracked=int(live_ms.size),
                        tracked_tick_ms_p50=float(np.median(live_ms))
                        if live_ms.size else None))
    summary["tracked_roll_profile"] = profile_tracked_roll(system, ticks,
                                                           frames)
    log(summary)
    # every WORKING cycle is one replay of the graph captured at the
    # first, and each replay runs every kernel of the cycle
    n_cycles = cycles.get("cycle.replays", 0)
    if not (system.status.value == "WORKING" and tracked
            and min(launches["closed_loop"].values()) > 0
            and n_cycles > 0 and cycles.get("graph.captures") == 1
            and "cycle.eager" not in cycles
            and min(launches["closed_loop"][k] for k in CYCLE_KERNELS)
            >= n_cycles
            and loop["ate"] < CLOSED_LOOP_ATE_BAR):
        raise AssertionError(f"closed loop failed: status "
                             f"{system.status.value}, ATE {loop['ate']}, "
                             f"launches {launches['closed_loop']}, "
                             f"cycles {cycles}")
    # every live tick a replay, none eager, one capture a tick body
    if not (live["system"].status.value == "WORKING" and live_ms.size
            and live_counts["tick.eager"] == 0
            and live_counts["tick.replays"] == len(live["walls"])
            and live_counts["graph.captures"] == len(live["system"]._ticks)
            + len(live["system"].cycle._static)):
        raise AssertionError(f"live ticks failed: {summary['live_ticks']}")
    log(dict(check_tracking_solve(system, cpu_rig, cfgs["rpg"]), card=card))
    log(dict(check_sgm(loop["boot"], cfgs["rpg"]), card=card))
    log(dict(check_precision(system, cpu_rig, cfgs["rpg"]), card=card))

    # the resident loop on the same scene and seed, from the same stream
    scene, ticks, evs = make_events("rpg", rigs["rpg"])
    resident = run_resident(rigs["rpg"], cfgs["rpg"], scene, ticks, evs,
                            host_traj=loop["traj"])
    resident["host_path_ms_per_tracked_tick"] = float(np.median(
        summary["ms_per_tracked_tick"]))
    log(resident)
    in_replays = resident["profiled_dispatch"]["kernel_launches"]
    vs_host = resident["vs_host_path"]
    if not (resident["status"] == "WORKING"
            and vs_host["max_t_diff_m"] == 0.0
            and vs_host["max_R_diff_rad"] == 0.0
            and resident["rolls_since_good"] == 0
            and resident["ate_m"] < CLOSED_LOOP_ATE_BAR
            and in_replays["patches"] >= RESIDENT_R
            and in_replays["lm"] >= RESIDENT_R
            and in_replays["remap"] >= 6 * RESIDENT_R
            and in_replays["track"] == RESIDENT_R * ROLL
            and in_replays["regularize"] >= RESIDENT_R
            and in_replays["bm"] >= RESIDENT_R
            and in_replays["fuse"] >= RESIDENT_R):
        raise AssertionError(f"resident loop failed: {resident}")

    # K1 at the event matcher's windows: 15x15 patches -> 16x16 windows,
    # N x (NB bands x K // NB slots) of them a surface
    em = EventMatcherConfig(**MV_EM)
    nb = math.ceil(2 * em.epipolar_threshold) + 1
    n_win = cfgs["rpg"].mapping.process_event_num * nb * (
        em.max_candidates // nb)
    checks[("patches", "matcher")] = check_patches(
        rigs["rpg"], n_win, h=em.patch_size_y + 1, w=em.patch_size_x + 1)
    log(dict(check=KERNELS["patches"]["name"], shape="rpg_matcher",
             windows=n_win, card=card, **checks[("patches", "matcher")]))
    mv_launches = mvstereo_phase(rigs, cpu_rig, cfgs["rpg"], streams["rpg"],
                                 card)
    log(dsec_em_cycle(rigs["dsec"], cfgs["dsec"], streams["dsec"], card))
    rd_launches = run_dataset_phase(rigs["rpg"], card)
    launches["demo"] = demo_phase(card)

    # the event simulator, the backend functions, the closed loop with
    # both backends attached, and the accuracy campaign
    esim_phase(card)
    backend_parity_phase(card)
    bl_launches = backend_loop_phase(card)
    launches["sim_campaign"] = sim_campaign_phase(card)

    # the event-axis sharding (world 1 on NCCL, world 2 on gloo over this
    # card) and the depth LM's scan / block matching's "matmul" volume
    scene, ticks, frames = streams["rpg"]
    launches["sharded"] = sharded_phase(card, scene, ticks, frames,
                                        loop["traj"])
    new_paths_phase(card)

    # the headline benchmark, and K1 / K2 at its shapes (rpg N = 4096,
    # DSEC N = 8192 windows of 24x32, 10 iterations)
    launches["bench"] = bench_phase(card)
    for shape, (n, disp) in BENCH_KERNEL_SHAPES.items():
        rig = rigs[shape.split("_")[1]]
        checks[("patches", shape)] = check_patches(rig, n)
        checks[("lm", shape)] = check_lm(rig, _bench_config(), n, disp)
        for k in ("patches", "lm"):
            log(dict(check=KERNELS[k]["name"], shape=shape, card=card,
                     **checks[(k, shape)]))

    phase_launches = [*launches.values(), *mv_launches.values(),
                      *rd_launches.values(), *bl_launches.values()]
    table = []
    for k, info in KERNELS.items():
        rpg, dsec = checks[(k, "rpg")], checks[(k, "dsec")]
        entry = dict(name=info["name"], route="cuda", source=info["source"],
                     replaces=info["replaces"],
                     launches=sum(n[k] for n in phase_launches),
                     closed_loop_launches=launches["closed_loop"][k],
                     mvstereo_launches={m: n[k] for m, n in
                                        mv_launches.items()},
                     run_dataset_launches={r: n[k] for r, n in
                                           rd_launches.items()},
                     backend_loop_launches={r: n[k] for r, n in
                                            bl_launches.items()},
                     sim_campaign_launches=launches["sim_campaign"][k],
                     sharded_launches=launches["sharded"][k],
                     bench_launches=launches["bench"][k],
                     demo_launches=launches["demo"][k],
                     resident_launches_per_roll=resident[
                         "profiled_dispatch"]["launches_per_roll"][k])
        entry.update(ms=rpg["kernel_ms"], **{key: rpg[key] for key in (
            "max_abs_err", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "call_ms", "timing")})
        entry.update({f"dsec_{key}": dsec[key] for key in (
            "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
            "library_ms")})
        if k == "patches":
            matcher = checks[("patches", "matcher")]
            entry.update({f"matcher_{key}": matcher[key] for key in (
                "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
                "library_ms")})
        for shape in BENCH_KERNEL_SHAPES:
            if (k, shape) in checks:
                entry.update({f"{shape}_{key}": checks[(k, shape)][key]
                              for key in ("max_abs_err", "kernel_ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")})
        for key in ("instantiation", "sort_ms", "rank_placement_ms",
                    "placement_library_ms"):
            if key in rpg:    # K6's instantiation, K7's placement
                entry.update({key: rpg[key], f"dsec_{key}": dsec[key]})
        for prefix, rec in (("", rpg), ("dsec_", dsec)):
            if "pair" in rec:
                entry.update({f"{prefix}pair_{key}": rec["pair"][key]
                              for key in ("kernel_ms", "bound_ms",
                                          "library_ms")})
        table.append(entry)
    log(dict(floor, card=card))
    for shape in (*shapes, "matcher", *BENCH_KERNEL_SHAPES):
        log(dict(k1_launch=shape, card=card,
                 **checks[("patches", shape)]["plan"]))
    for shape in (*shapes, *BENCH_KERNEL_SHAPES):
        log(dict(k2_launch=shape, card=card,
                 **checks[("lm", shape)]["plan"]))
    log(dict(k4_launch="rpg, dsec", card=card, **k4_plan()))
    for shape in shapes:
        log(dict(k5_launch=shape, card=card,
                 **k5_plan(cfgs[shape].regularizer)))
    for shape in shapes:
        bcfg = cfgs[shape].bm
        D = bcfg.max_disparity - bcfg.min_disparity + 1
        for wy, wx in ((bcfg.patch_size_y, bcfg.patch_size_x),
                       (bcfg.patch_size_x, bcfg.patch_size_y), (5, 9)):
            log(dict(k6_launch=shape, card=card, **k6_plan(wy, wx, D),
                     shared_loads_per_pair_from_plan=k6_shared_loads(
                         wy, wx, D)))
    log(f"card: {card}")
    log(dict(kernels=table))
    log(dict(ok=True, device=dict(platform="gpu", kind=kind,
                                  count=torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
