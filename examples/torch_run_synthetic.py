"""End-to-end demo on the PyTorch/CUDA port: synthetic stereo events ->
depth maps + trajectory.

The port of examples/run_synthetic.py: the full closed loop (SGM
bootstrap -> mapping <-> tracking -> optional BA / loop-closure
backends) on a simulated scene, reporting depth-map size and trajectory
ATE against ground truth. Runs on the CUDA card unless --device cpu is
given; without a card it raises (nothing falls back to the CPU).

    python3 examples/torch_run_synthetic.py [n_ticks] [--ba] \
        [--loop-closure] [--device cuda|cpu]

The trajectory is written to build/torch_run_synthetic_traj.txt (TUM
format) under the repository root.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from esvo_tpu_torch.eval.trajectory import ate_rmse  # noqa: E402
from esvo_tpu_torch.geometry.camera import make_ideal_rig  # noqa: E402
from esvo_tpu_torch.io.events import frame_events  # noqa: E402
from esvo_tpu_torch.io.synthetic import (  # noqa: E402
    interpolate_gt_pose, make_scene, simulate_stereo_events)
from esvo_tpu_torch.mapping.block_matching import (  # noqa: E402
    BlockMatchConfig)
from esvo_tpu_torch.mapping.depth_refinement import (  # noqa: E402
    DepthProblemConfig)
from esvo_tpu_torch.runtime.backend_loop import BackendLoop  # noqa: E402
from esvo_tpu_torch.runtime.config import (  # noqa: E402
    MappingConfig, SystemConfig)
from esvo_tpu_torch.runtime.pose_graph_loop import (  # noqa: E402
    PoseGraphLoop)
from esvo_tpu_torch.runtime.system import EsvoSystem  # noqa: E402

W, H, FX, BASELINE, TICK = 240, 180, 150.0, 0.1, 0.01
TRAJECTORY = ROOT / "build" / "torch_run_synthetic_traj.txt"
ATE_BAR = 0.1


def device_line(dev: torch.device) -> str:
    """The device a run's numbers come from: on the card its name and
    power limit as nvidia-smi reports them."""
    if dev.type != "cuda":
        return f"device: cpu ({torch.get_num_threads()} threads)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return f"device: {out.stdout.strip().splitlines()[dev.index or 0]}"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_ticks", type=int, nargs="?", default=60)
    ap.add_argument("--ba", action="store_true")
    ap.add_argument("--loop-closure", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "false); pass --device cpu to run on the CPU")
    print(device_line(dev), flush=True)

    rng = np.random.default_rng(7)
    rig = make_ideal_rig(W, H, FX, FX, W / 2 - 0.5, H / 2 - 0.5, BASELINE,
                         dtype=torch.float32, device=dev)
    duration = max((args.n_ticks + 2) * TICK, 0.2)
    scene = make_scene(rng, num_points=4000, duration=duration,
                       steps=int(duration * 100) + 1, motion_scale=0.6)
    ev_l, ev_r = simulate_stereo_events(
        scene, rig.left.params.P.double().cpu().numpy(),
        rig.right.params.P.double().cpu().numpy(), W, H,
        pixel_threshold=0.75, rng=rng)
    print(f"simulated events: L={len(ev_l)} R={len(ev_r)}")
    ticks = np.arange(TICK, duration, TICK)
    fl = frame_events(ev_l, ticks, 3000)
    fr = frame_events(ev_r, ticks, 3000)

    cfg = SystemConfig(
        depth=DepthProblemConfig(max_iteration=8),
        bm=BlockMatchConfig(zncc_threshold=0.25),
        mapping=MappingConfig(process_event_num=800,
                              init_sgm_num_threshold=300,
                              std_var_vis_threshold=0.05,
                              age_vis_threshold=0, denoising=False,
                              regularization=False))
    system = EsvoSystem(rig, cfg, device=dev)
    backend = BackendLoop(system) if args.ba else None
    pose_graph = (PoseGraphLoop(system, keyframe_every=1)
                  if args.loop_closure else None)

    t0 = time.perf_counter()
    for k in range(min(args.n_ticks, len(ticks))):
        frame = lambda f: {key: v[k] for key, v in f.items()
                           if key != "dropped"}
        out = system.process_tick(float(ticks[k]), frame(fl), frame(fr),
                                  do_mapping=(k % 5 == 4))
        if backend:
            backend.maybe_update(out)
        if pose_graph:
            pg_stats = pose_graph.maybe_update(out)
            if pg_stats and "pg_cost_final" in pg_stats:
                print(f"tick {k}: loop closure -> kf "
                      f"{pg_stats['lc_candidate']} "
                      f"(sim {pg_stats['lc_similarity']:.3f})")
        if k % 10 == 9:
            print(f"tick {k}: {system.status.value} "
                  f"map_points={system.stats['map_points']}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    t_est, T_est = system.trajectory()
    gt = np.stack([interpolate_gt_pose(scene, t) for t in t_est])
    ate = ate_rmse(t_est, T_est, t_est, gt, align=True)
    _, occ = system.depth_map()
    res = dict(status=system.status.value, ticks=len(t_est), wall_s=wall,
               map_points=int(occ.sum()), ate_m=float(ate))
    print(f"ticks: {len(t_est)} in {wall:.1f}s "
          f"({len(t_est) / wall:.1f} ticks/s)")
    print(f"map points: {res['map_points']}")
    print(f"ATE RMSE: {ate:.4f} m")
    if backend:
        res["ba_runs"] = backend.num_ba_runs
        print(f"BA runs: {backend.num_ba_runs}")
    if pose_graph:
        res["loop_closures"] = pose_graph.num_loop_closures
        print(f"loop closures: {pose_graph.num_loop_closures}")
    TRAJECTORY.parent.mkdir(parents=True, exist_ok=True)
    system.save_trajectory(str(TRAJECTORY))
    print(f"trajectory saved to {TRAJECTORY}")
    if not ate < ATE_BAR:
        raise RuntimeError(f"trajectory diverged: ATE {ate} m")
    print("E2E DEMO OK")
    return res


if __name__ == "__main__":
    main()
