"""Weak-scaling efficiency of every sharded pipeline stage, the
PyTorch/CUDA counterpart of scripts/bench_scaling.py.

Measures every stage that parallel/sharding.py shards, including the ones
with real cross-rank traffic:

| stage      | sharded axis | collectives (counted where the port sends them) |
|---|---|---|
| solve      | events       | all-gather of the estimates (10 fields)         |
| surface    | events       | 2x MAX all-reduce of the (H, W) grids           |
| tracking   | map points   | SUM all-reduce of J^T J (6,6) + J^T r (6) + cost|
| ba         | observations | SUM all-reduced Schur normal-equation blocks    |
| pose_graph | edges        | SUM all-reduced (6K, 6K) normal equations       |

Each device count runs as that many SPMD ranks (parallel/sharding.py
run_ranks): gloo processes on the CPU (``--device cpu``), NCCL ranks one
card each on CUDA. Every rank gets the same inputs, drawn in the parent
from one seed. Per stage and rank count: rank 0's wall time a step,
throughput, **CPU time a step of rank 0's process** (each rank is its own
process, so this is the CPU time per shard: ranks sharing one host's
cores oversubscribe the wall clock, while CPU-per-shard growth isolates
the sharding and collective overhead; projected multi-device weak-scaling
efficiency = cpu_per_shard(1) / cpu_per_shard(n)), and **collective
bytes a step**: the bytes of each collective's result, counted by
parallel/sharding.py's COLLECTIVE_BYTES (JAX's script parses the same
sums from its compiled HLO).

    python3 scripts/torch_bench_scaling.py --device cpu --devices 1,2,4,8
    python3 scripts/torch_bench_scaling.py --devices 1      # one card

On CUDA a rank count above the visible cards is skipped. Writes markdown
tables, headed by the device line (the card's name and power limit), to
stdout and (with --out) to a file.
"""
import argparse
import os
import resource
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from esvo_tpu_torch.backend import bundle_adjustment as ba  # noqa: E402
from esvo_tpu_torch.backend import pose_graph as pg  # noqa: E402
from esvo_tpu_torch.geometry.camera import make_ideal_rig  # noqa: E402
from esvo_tpu_torch.mapping import depth_refinement as dr  # noqa: E402
from esvo_tpu_torch.parallel import sharding as ps  # noqa: E402
from esvo_tpu_torch.surface import time_surface as tsf  # noqa: E402
from esvo_tpu_torch.tracking import registration as reg  # noqa: E402
from torch_bench import (  # noqa: E402
    block, device_info, device_stamp, resolve_device)

W, H = 240, 180
DISP = 8
BA_KEYFRAMES, BA_POINTS, BA_ITERS = 8, 512, 5
PG_POSES, PG_ITERS = 256, 5
SOLVE_ITERS = 8


# ---- per-stage inputs for n ranks, drawn in the parent (numpy) ----------

def draw_solve(rng, n, args):
    N = args.events_per_device * n
    coords = np.stack([rng.uniform(30, W - 30, N),
                       rng.uniform(20, H - 20, N)], axis=1)
    d_init = DISP / (0.1 * 200.0) * rng.uniform(0.85, 1.15, N)
    return dict(coords=coords, d_init=d_init), N


def draw_surface(rng, n, args):
    N = args.events_per_device * n
    return dict(x=rng.integers(0, W, N), y=rng.integers(0, H, N),
                t=np.sort(rng.uniform(0, 0.01, N)).astype(np.float32),
                p=rng.random(N) > 0.5), N


def draw_tracking(rng, n, args):
    M = args.points_per_device * n
    pts = np.stack([rng.uniform(-0.8, 0.8, M), rng.uniform(-0.5, 0.5, M),
                    rng.uniform(1.5, 3.0, M)], axis=1)
    return dict(pts=pts), M


def draw_ba(rng, n, args):
    M = args.obs_per_device * n
    K, Pn = BA_KEYFRAMES, BA_POINTS
    pts = np.stack([rng.uniform(-1, 1, Pn), rng.uniform(-0.7, 0.7, Pn),
                    rng.uniform(2.0, 4.0, Pn)], axis=1)
    T_kf = np.broadcast_to(np.eye(4), (K, 4, 4)).copy()
    T_kf[:, 0, 3] = np.linspace(-0.2, 0.2, K)
    obs_kf = rng.integers(0, K, M)
    obs_pt = rng.integers(0, Pn, M)
    p_cam = pts[obs_pt] - T_kf[obs_kf][:, :3, 3]
    uv = np.stack([200.0 * p_cam[:, 0] / p_cam[:, 2] + W / 2 - 0.5,
                   200.0 * p_cam[:, 1] / p_cam[:, 2] + H / 2 - 0.5],
                  axis=1) + rng.normal(0, 0.5, (M, 2))
    return dict(T_kf=T_kf, pts=pts, obs_kf=obs_kf, obs_pt=obs_pt, uv=uv), M


def draw_pose_graph(rng, n, args):
    E = args.edges_per_device * n
    K = PG_POSES
    ang = np.linspace(0, 2 * np.pi, K)
    T = np.broadcast_to(np.eye(4), (K, 4, 4)).copy()
    T[:, 0, 3] = np.cos(ang)
    T[:, 1, 3] = np.sin(ang)
    ei = np.concatenate([np.arange(K - 1),
                         rng.integers(0, K // 2, max(E - K + 1, 1))])[:E]
    ej = np.concatenate([np.arange(1, K),
                         rng.integers(K // 2, K, max(E - K + 1, 1))])[:E]
    T_ij = np.einsum("eij,ejk->eik", np.linalg.inv(T[ei]), T[ej])
    return dict(T=T, ei=ei, ej=ej, T_ij=T_ij), E


DRAW = {"solve": draw_solve, "surface": draw_surface,
        "tracking": draw_tracking, "ba": draw_ba,
        "pose_graph": draw_pose_graph}


# ---- per-stage programs on a rank: (fn, args) --------------------------

def build_solve(w, rig, ts_l, ts_r, mesh, dev):
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    N = w["coords"].shape[0]
    eye = torch.eye(4, dtype=torch.float32, device=dev).expand(N, 4, 4)
    cfg = dr.DepthProblemConfig(max_iteration=SOLVE_ITERS)
    fn = ps.sharded_depth_solve(mesh, rig, cfg)
    return fn, (f(w["coords"]), eye, eye, f(w["d_init"]),
                torch.ones(N, dtype=torch.bool, device=dev),
                torch.zeros(N, dtype=torch.float32, device=dev), ts_l, ts_r)


def build_surface(w, rig, ts_l, ts_r, mesh, dev):
    ev = tsf.EventBatch.from_arrays(w["x"], w["y"], w["t"], w["p"],
                                    device=dev)
    state = tsf.init_state(H, W, dev)
    return (lambda st, e: ps.sharded_surface_update(mesh, st, e)), (state, ev)


def build_tracking(w, rig, ts_l, ts_r, mesh, dev):
    cfg = reg.RegProblemConfig()
    neg, gu, gv = reg.negative_time_surface(ts_l, cfg.kernel_size)
    step = ps.sharded_tracking_step(mesh, rig.left, cfg)
    pts = torch.as_tensor(w["pts"], dtype=torch.float32, device=dev)
    return step, (torch.eye(3, device=dev), torch.zeros(3, device=dev),
                  torch.eye(4, device=dev), neg, gu, gv, pts,
                  torch.ones(pts.shape[0], dtype=torch.bool, device=dev))


def build_ba(w, rig, ts_l, ts_r, mesh, dev):
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    i = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
    M = w["obs_kf"].shape[0]
    prob = ba.BAProblem(
        T_world_kf=f(w["T_kf"]), points=f(w["pts"]), obs_kf=i(w["obs_kf"]),
        obs_point=i(w["obs_pt"]), obs_uv=f(w["uv"]),
        obs_valid=torch.ones(M, dtype=torch.bool, device=dev),
        fx=f(200.0), fy=f(200.0), cx=f(W / 2 - 0.5), cy=f(H / 2 - 0.5))
    return ps.sharded_bundle_adjust(mesh, ba.BAConfig(
        max_iterations=BA_ITERS)), (prob,)


def build_pose_graph(w, rig, ts_l, ts_r, mesh, dev):
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    i = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
    E = w["ei"].shape[0]
    graph = pg.PoseGraph(
        T_world=f(w["T"]), edge_i=i(w["ei"]), edge_j=i(w["ej"]),
        T_ij=f(w["T_ij"]), w_rot=torch.full((E,), 100.0, device=dev),
        w_trans=torch.full((E,), 100.0, device=dev),
        edge_valid=torch.ones(E, dtype=torch.bool, device=dev))
    return ps.sharded_pose_graph(mesh, pg.PoseGraphConfig(
        max_iterations=PG_ITERS)), (graph,)


BUILD = {"solve": build_solve, "surface": build_surface,
         "tracking": build_tracking, "ba": build_ba,
         "pose_graph": build_pose_graph}


def measure(fn, args, reps):
    """(wall s/step, this process's cpu s/step, collective bytes by op of
    one step) of fn(*args), after one warm-up step."""
    ps.COLLECTIVE_BYTES.clear()
    fn(*args)
    block()
    coll = dict(ps.COLLECTIVE_BYTES)
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    block()
    wall = (time.perf_counter() - t0) / reps
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    cpu = ((ru1.ru_utime + ru1.ru_stime)
           - (ru0.ru_utime + ru0.ru_stime)) / reps
    return wall, cpu, coll


def rank_stages(stages, worlds, surfaces, reps, device):
    """One rank's run of every stage (run_ranks' fn): {stage: (wall, cpu,
    collective bytes by op)}."""
    mesh = ps.make_mesh()
    rig = make_ideal_rig(W, H, 200.0, 200.0, W / 2 - 0.5, H / 2 - 0.5, 0.1,
                         dtype=torch.float32, device=device)
    ts_l, ts_r = (torch.as_tensor(s, dtype=torch.float32, device=device)
                  for s in surfaces)
    out = {}
    for stage in stages:
        fn, fargs = BUILD[stage](worlds[stage], rig, ts_l, ts_r, mesh,
                                 device)
        out[stage] = measure(fn, fargs, reps)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--events-per-device", type=int, default=2048)
    ap.add_argument("--points-per-device", type=int, default=2048)
    ap.add_argument("--obs-per-device", type=int, default=2048)
    ap.add_argument("--edges-per-device", type=int, default=64)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--stages", default="solve,surface,tracking,ba,"
                    "pose_graph")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    stamp = device_stamp(device_info(dev))
    print(stamp, flush=True)
    dev_counts = [int(s) for s in args.devices.split(",")]
    stages = args.stages.split(",")

    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, size=(H, W + 64)).astype(np.float32)
    k = np.ones(5) / 5
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    surfaces = (np.ascontiguousarray(base[:, 32:32 + W]),
                np.ascontiguousarray(base[:, 32 + DISP:32 + DISP + W]))

    results = {s: [] for s in stages}
    refs = {}
    for n_dev in dev_counts:
        if dev.type == "cuda" and n_dev > torch.cuda.device_count():
            print(f"skip n={n_dev}: only {torch.cuda.device_count()} "
                  f"devices")
            continue
        drawn = {stage: DRAW[stage](rng, n_dev, args) for stage in stages}
        worlds = {stage: w for stage, (w, _) in drawn.items()}
        timed = ps.run_ranks(rank_stages, n_dev, stages, worlds, surfaces,
                             args.reps, device=dev.type)
        for stage in stages:
            items = drawn[stage][1]
            wall, cpu_shard, coll = timed[stage]
            if stage not in refs:
                refs[stage] = (wall, cpu_shard)
            w1, c1 = refs[stage]
            eff_wall = w1 / wall
            eff_proj = c1 / max(cpu_shard, 1e-12)
            coll_total = sum(coll.values())
            results[stage].append(
                (n_dev, items, wall * 1e3, eff_wall, cpu_shard * 1e3,
                 eff_proj, coll_total, coll))
            print(f"{stage:>10}  n={n_dev}  items={items:7d}  "
                  f"wall {wall*1e3:8.2f} ms  wall-eff {eff_wall*100:5.1f}%  "
                  f"cpu/shard {cpu_shard*1e3:7.2f} ms  "
                  f"sharding-eff {eff_proj*100:5.1f}%  "
                  f"collectives {coll_total/1e3:.1f} kB {coll}", flush=True)

    blocks = [stamp]
    for stage in stages:
        lines = [
            f"### {stage}",
            "",
            "| devices | items | wall (ms) | wall-clock eff "
            "(oversubscribed) | CPU ms/shard | sharding eff "
            "(projected multi-device) | collective kB/step | by op |",
            "|---|---|---|---|---|---|---|---|",
        ]
        for (n_dev, items, ms, effw, cpums, effp, cb,
             coll) in results[stage]:
            by_op = ", ".join(f"{k} {v/1e3:.1f}"
                              for k, v in sorted(coll.items())) or "-"
            lines.append(
                f"| {n_dev} | {items} | {ms:.2f} | {effw*100:.1f}% "
                f"| {cpums:.2f} | {effp*100:.1f}% | {cb/1e3:.1f} "
                f"| {by_op} |")
        blocks.append("\n".join(lines))
    table = "\n\n".join(blocks)
    print()
    print(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table + "\n")
    return results


if __name__ == "__main__":
    main()
