"""Per-stage wall-time profile of the system pipeline (test config), the
PyTorch/CUDA counterpart of scripts/profile_system.py.

Each tick runs inside a utils/profiling.py StageTimer stage that ends in
a synchronize of the card, so a stage's time holds its device work. The
world is tests/test_system.py's (scripts/torch_bench_ticks.py keeps the
port's copy). Runs on the CUDA card unless --device cpu is given; the
first line names the device (the card's name and power limit).

Run:  python3 scripts/torch_profile_system.py [n_ticks] [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from esvo_tpu_torch.io.events import frame_events  # noqa: E402
from esvo_tpu_torch.io.synthetic import (  # noqa: E402
    interpolate_gt_pose, make_scene, simulate_stereo_events)
from esvo_tpu_torch.runtime.system import EsvoSystem  # noqa: E402
from esvo_tpu_torch.utils.profiling import StageTimer  # noqa: E402
from torch_bench import (  # noqa: E402
    block, device_info, device_stamp, resolve_device)
from torch_bench_ticks import (  # noqa: E402
    H, TICK, W, frame_at, make_config, make_rig)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n_ticks", nargs="?", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(device_stamp(device_info(dev)), flush=True)
    n_ticks = args.n_ticks
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    rig = make_rig(dev)
    print(f"rig: {time.perf_counter()-t0:.1f}s")
    t0 = time.perf_counter()
    scene = make_scene(rng, num_points=1500, duration=0.8, steps=81,
                       motion_scale=0.6)
    ev_l, ev_r = simulate_stereo_events(
        scene, rig.left.params.P.double().cpu().numpy(),
        rig.right.params.P.double().cpu().numpy(), W, H,
        pixel_threshold=0.75, rng=rng)
    print(f"simulate: {time.perf_counter()-t0:.1f}s  "
          f"events L={len(ev_l)} R={len(ev_r)}")
    ticks = np.arange(TICK, 0.8, TICK)
    frames_l = frame_events(ev_l, ticks, 3000)
    frames_r = frame_events(ev_r, ticks, 3000)

    system = EsvoSystem(rig, make_config(), device=dev)
    timer = StageTimer()
    for k in range(n_ticks):
        t = float(ticks[k])
        gt = interpolate_gt_pose(scene, t)
        name = f"tick{'_map' if k % 5 == 4 else ''}"
        with timer.stage(name + ("_first" if k < 5 else "")):
            out = system.process_tick(t, frame_at(frames_l, k),
                                      frame_at(frames_r, k), gt_pose=gt,
                                      do_mapping=(k % 5 == 4))
            block()
        print(k, system.status.value, out.get("sgm_points"),
              out.get("map_estimates"), out.get("map_points"), flush=True)
    print(timer.summary())
    return timer


if __name__ == "__main__":
    main()
