"""Calibrate chip_smoke.py's closed-loop ATE bars on the CPU port.

    python scripts/torch_closed_loop_ate.py [--seeds 12] [--threads 4]
    python scripts/torch_closed_loop_ate.py --bench [--seeds 4]

Runs chip_smoke.py's rpg closed loop (the same rig, stream and rolls)
through the PyTorch port on the CPU once per point-selection seed and
prints one JSON line per seed (ATE against the scene's ground truth, the
ATE of a pose held at the start, tracker rejections, final status), then
a summary line with the range. With --bench it runs
scripts/torch_bench.py's closed loop instead (the resident loop swept
over 5 / 10 / 25 / 50-tick dispatches, then the host roll path; ~2 min a
seed on 4 threads) and prints its ATE by dispatch size per seed, then
the range against chip_smoke.py's BENCH_ATE_BAR. Needs no GPU.
"""
from __future__ import annotations

import argparse
import functools
import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--bench", action="store_true",
                    help="calibrate the bench phase's closed loop")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    if args.bench:
        return bench_ates(args.seeds)
    cfg = cs.SystemConfig.from_dict(cs.RPG)
    rig = cs.make_rig("rpg", "cpu")
    scene, ticks, frames = cs.make_stream("rpg", rig)
    ates = []
    for seed in range(args.seeds):
        loop = cs.run_closed_loop(rig, cfg, scene, ticks, frames, "cpu",
                                  log_rolls=False, seed=seed)
        ates.append(loop["ate"])
        print(json.dumps(dict(seed=seed, device="cpu", ticks=loop["ticks"],
                              ate_m=loop["ate"],
                              static_pose_ate_m=loop["static_ate"],
                              tracking_rejects=loop["system"].stats[
                                  "tracking_rejects"],
                              status=loop["system"].status.value)),
              flush=True)
    print(json.dumps(dict(seeds=args.seeds, ate_min_m=min(ates),
                          ate_max_m=max(ates),
                          ate_mean_m=sum(ates) / len(ates),
                          bar_m=cs.CLOSED_LOOP_ATE_BAR)))
    return 0


def bench_ates(seeds: int) -> int:
    import torch_bench as tb
    ates = []
    for seed in range(seeds):
        # torch_bench's loop builds its EsvoSystem with the default seed;
        # each calibration run draws its points from another one
        tb.EsvoSystem = functools.partial(cs.EsvoSystem, seed=seed)
        out = tb.bench_closed_loop(device="cpu")
        ates += out["ate_by_dispatch"].values()
        print(json.dumps(dict(seed=seed, device="cpu",
                              ate_by_dispatch=out["ate_by_dispatch"],
                              n_ticks=out["n_ticks"])), flush=True)
    print(json.dumps(dict(seeds=seeds, ate_min_m=min(ates),
                          ate_max_m=max(ates),
                          ate_mean_m=sum(ates) / len(ates),
                          bar_m=cs.BENCH_ATE_BAR)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
