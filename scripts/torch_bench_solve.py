"""Micro-benchmark for the depth-LM solver (the mapping cycle's hot stage),
the PyTorch/CUDA counterpart of scripts/bench_solve.py.

Times dr.solve alone (kernels K1 and K2 on the card) at rpg scale
(240x180, N=4096) and DSEC scale (640x480, N=8192), sweeping
max_iteration to separate the fixed cost (window gather, initial eval,
variance) from the per-iteration cost. Runs on the CUDA card unless
--device cpu is given; the first line names the device (the card's name
and power limit).

Usage: python3 scripts/torch_bench_solve.py [--dsec] [--iters 0,1,4,8]
                                            [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from esvo_tpu_torch.geometry.camera import make_ideal_rig  # noqa: E402
from esvo_tpu_torch.mapping import depth_refinement as dr  # noqa: E402
from torch_bench import (  # noqa: E402
    block, device_info, device_stamp, resolve_device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dsec", action="store_true")
    ap.add_argument("--iters", default="0,1,8")
    ap.add_argument("--n", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(device_stamp(device_info(dev)), flush=True)

    if args.dsec:
        W, H, N = 640, 480, 8192
    else:
        W, H, N = 240, 180, 4096
    if args.n:
        N = args.n

    rng = np.random.default_rng(0)
    rig = make_ideal_rig(W, H, 200.0, 200.0, W / 2 - 0.5, H / 2 - 0.5,
                         0.1, dtype=torch.float32, device=dev)
    disp = 8
    base = rng.uniform(0, 255, size=(H, W + 64)).astype(np.float32)
    k = np.ones(5) / 5
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                  dtype=torch.float32, device=dev)
    ts_l = t(base[:, 32:32 + W])
    ts_r = t(base[:, 32 + disp:32 + disp + W])

    coords = torch.stack([t(rng.uniform(30, W - 30, N)),
                          t(rng.uniform(20, H - 20, N))], dim=1)
    d_true = disp / (0.1 * 200.0)
    d_init = t(d_true * rng.uniform(0.85, 1.15, N))
    eye = torch.eye(4, dtype=torch.float32, device=dev).expand(N, 4, 4)
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    t_ev = torch.zeros(N, dtype=torch.float32, device=dev)

    rows = []
    for iters in [int(s) for s in args.iters.split(",")]:
        cfg = dr.DepthProblemConfig(max_iteration=max(iters, 1))
        if iters == 0:
            cfg = dr.DepthProblemConfig(max_iteration=1)

        fn = lambda cfg=cfg: dr.solve(coords, eye, eye, d_init, valid, t_ev,
                                      ts_l, ts_r, rig, cfg)
        out = fn()
        block()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = fn()
        block()
        dt = (time.perf_counter() - t0) / args.reps
        nvalid = int(out.valid.sum())
        print(f"iters={iters:2d}  {dt * 1e3:7.2f} ms   "
              f"({N / dt / 1e3:8.1f} k ev/s)  valid={nvalid}", flush=True)
        rows.append(dict(iters=iters, ms=dt * 1e3, valid=nvalid))
    return rows


if __name__ == "__main__":
    main()
