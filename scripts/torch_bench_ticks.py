"""System-level ticks/s: sequential process_tick vs rolled process_ticks,
the PyTorch/CUDA counterpart of scripts/bench_ticks.py.

The reference hides latency by running its time-surface, mapping, and
tracking nodes as separate processes at different rates
(launch/system/system_rpg.launch:5-63). The port's analogue is the
process_ticks roll: K surface updates + K chained tracking solves in one
call, with the mapping cycle handed over at the roll boundary. This
script measures the steady-state WORKING-phase tick rate both ways on
the same synthetic closed-loop workload (100 Hz tick schedule, mapping
every 5th tick), the world of the JAX package's tests/test_system.py,
of which this file keeps its own copy (W, H, FX, BASELINE, TICK,
make_config, frame_at). Runs on the CUDA card unless --device cpu is
given; the first line names the device (the card's name and power
limit).

Usage: python3 scripts/torch_bench_ticks.py [--ticks 60] [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from esvo_tpu_torch.geometry.camera import make_ideal_rig  # noqa: E402
from esvo_tpu_torch.io.events import frame_events  # noqa: E402
from esvo_tpu_torch.io.synthetic import (  # noqa: E402
    make_scene, simulate_stereo_events)
from esvo_tpu_torch.mapping.block_matching import (  # noqa: E402
    BlockMatchConfig)
from esvo_tpu_torch.mapping.depth_refinement import (  # noqa: E402
    DepthProblemConfig)
from esvo_tpu_torch.mapping.initialization import SGMConfig  # noqa: E402
from esvo_tpu_torch.runtime.config import (  # noqa: E402
    MappingConfig, SystemConfig)
from esvo_tpu_torch.runtime.system import (  # noqa: E402
    EsvoSystem, SystemStatus)
from torch_bench import (  # noqa: E402
    block, device_info, device_stamp, resolve_device)

# tests/test_system.py's world
W, H = 240, 180
FX = 150.0
BASELINE = 0.1
TICK = 0.01  # 100 Hz


def make_config():
    # Synthetic streams are sparser and cleaner than real sensors, so the
    # sensor-noise-oriented knobs are relaxed: no median-blur denoiser (it
    # rejects isolated synthetic pixels), no regularizer (it needs real
    # semi-dense edge density), looser ZNCC on the dotty surfaces.
    return SystemConfig(
        depth=DepthProblemConfig(max_iteration=8),
        bm=BlockMatchConfig(zncc_threshold=0.25),
        sgm=SGMConfig(num_disparities=48),
        mapping=MappingConfig(process_event_num=800,
                              init_sgm_num_threshold=300,
                              std_var_vis_threshold=0.05,
                              age_vis_threshold=0,
                              denoising=False,
                              regularization=False))


def frame_at(frames, k):
    return {key: v[k] for key, v in frames.items() if key != "dropped"}


def make_rig(device):
    return make_ideal_rig(W, H, FX, FX, W / 2 - 0.5, H / 2 - 0.5, BASELINE,
                          dtype=torch.float32, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=60)
    ap.add_argument("--roll", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(device_stamp(device_info(dev)), flush=True)

    rng = np.random.default_rng(7)
    rig = make_rig(dev)
    scene = make_scene(rng, num_points=4000, duration=0.8, steps=81,
                       motion_scale=0.6)
    ev_l, ev_r = simulate_stereo_events(
        scene, rig.left.params.P.double().cpu().numpy(),
        rig.right.params.P.double().cpu().numpy(), W, H,
        pixel_threshold=0.75, rng=rng)
    ticks = np.arange(TICK, 0.8, TICK)
    frames_l = frame_events(ev_l, ticks, 3000)
    frames_r = frame_events(ev_r, ticks, 3000)
    n_ticks = min(args.ticks, len(ticks))
    R = args.roll

    def check_working(system):
        if system.status != SystemStatus.WORKING:
            raise RuntimeError(f"no WORKING status after {n_ticks} ticks "
                               f"({system.status.value})")

    def run_sequential(system):
        system.reset()
        t0 = None
        for k in range(n_ticks):
            if k == R and t0 is None:
                block()
                t0 = time.perf_counter()   # skip bootstrap
            system.process_tick(float(ticks[k]), frame_at(frames_l, k),
                                frame_at(frames_r, k),
                                do_mapping=(k % R == R - 1))
        block()
        rate = (n_ticks - R) / (time.perf_counter() - t0)
        check_working(system)
        return rate

    def run_rolled(system):
        system.reset()
        t0 = None
        for k0 in range(0, n_ticks, R):
            if k0 == R and t0 is None:
                block()
                t0 = time.perf_counter()
            sl = slice(k0, k0 + R)
            evl = {key: v[sl] for key, v in frames_l.items()
                   if key != "dropped"}
            evr = {key: v[sl] for key, v in frames_r.items()
                   if key != "dropped"}
            system.process_ticks(ticks[sl], evl, evr, do_mapping=True)
        system.flush()
        block()
        rate = (n_ticks - R) / (time.perf_counter() - t0)
        check_working(system)
        return rate

    # one system per path; the first pass warms up (kernel builds, the
    # allocator's caches), the second is the measurement
    rates = {}
    for name, fn in [("sequential", run_sequential), ("rolled", run_rolled)]:
        system = EsvoSystem(rig, make_config(), device=dev)
        fn(system)               # warm-up
        rates[name] = fn(system)  # measured
        print(f"{name:12s} {rates[name]:8.1f} ticks/s", flush=True)
    print(f"speedup: {rates['rolled'] / rates['sequential']:.2f}x")
    return rates


if __name__ == "__main__":
    main()
