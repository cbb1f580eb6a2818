"""Calibrate chip_smoke.py's closed-loop ATE bar on the CPU port.

    python scripts/torch_closed_loop_ate.py [--seeds 12] [--threads 4]

Runs chip_smoke.py's rpg closed loop (the same rig, stream and rolls)
through the PyTorch port on the CPU once per point-selection seed and
prints one JSON line per seed (ATE against the scene's ground truth, the
ATE of a pose held at the start, tracker rejections, final status), then
a summary line with the range. Needs no GPU.
"""
from __future__ import annotations

import argparse
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
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
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


if __name__ == "__main__":
    sys.exit(main())
