"""How robust is the loop-closure e2e scene's one revisit?

    python scripts/torch_loop_closure_sensitivity.py --device cpu \
        [--magnitudes 0 1e-6 1e-4] [--seeds 6]

Drives tests/test_loop_closure_e2e.py's scene and drive (chip_smoke.py's
backend world, PoseGraphLoop alone, a tick at a time on the host path)
once unperturbed and, for each magnitude m > 0, once per seed with a
change of world frame applied after tick 10 through
EsvoSystem.apply_world_correction: a rotation of m rad about a random
axis and a translation of m m in each axis (normal draws). Such a
correction moves every world-frame quantity together, as a BA or
pose-graph fold-back does, so it changes nothing but rounding. Prints
one JSON line a run (loop closures, each ICP verification's gate
values; on a CUDA device also whether the verification, repeated on
CPU copies of its inputs, agrees) and a summary line: runs that closed
the loop, per magnitude.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from esvo_tpu_torch.backend import loop_closure as lc  # noqa: E402
from esvo_tpu_torch.runtime.pose_graph_loop import PoseGraphLoop  # noqa: E402
from esvo_tpu_torch.runtime.system import EsvoSystem  # noqa: E402

AT_TICK = 10        # after the bootstrap and the first mapping cycles


def world_correction(magnitude: float, seed: int) -> np.ndarray:
    """A rigid 4x4: `magnitude` rad about a random axis, a translation
    of normal draws times `magnitude` m."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                  [-axis[1], axis[0], 0.0]])
    corr = np.eye(4)
    corr[:3, :3] = (np.eye(3) + np.sin(magnitude) * K
                    + (1 - np.cos(magnitude)) * K @ K)
    corr[:3, 3] = rng.normal(size=3) * magnitude
    return corr


def drive(world, device, corr=None) -> dict:
    """The e2e test's drive with `corr` folded in after tick AT_TICK."""
    rig, _scene, ticks, frames, cfg = world
    pick = lambda f, k: {key: v[k] for key, v in f.items() if key != "dropped"}
    system = EsvoSystem(rig, cfg, device=device, seed=0)
    pgl = PoseGraphLoop(system, keyframe_every=1,
                        lc_config=lc.LoopClosureConfig(min_gap=4,
                                                       min_similarity=0.88))
    verified = []
    inner = lc.verify_loop_icp

    def record(*a, **kw):
        res = inner(*a, **kw)
        rec = dict(accepted=res[0], **res[4])
        if torch.device(device).type == "cuda":
            host = [t.cpu() if torch.is_tensor(t) else t for t in a]
            rec["cpu_recheck_accepted"] = inner(*host, **kw)[0]
        verified.append(rec)
        return res

    lc.verify_loop_icp = record
    n = len(ticks)
    try:
        for k in range(n):
            out = system.process_tick(float(ticks[k]), pick(frames[0], k),
                                      pick(frames[1], k),
                                      do_mapping=(k % 5 == 4 or k == n - 1))
            pgl.maybe_update(out)
            if corr is not None and k == AT_TICK:
                system.apply_world_correction(corr)
    finally:
        lc.verify_loop_icp = inner
    return dict(status=system.status.value,
                loop_closures=pgl.num_loop_closures, verified=verified)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--magnitudes", type=float, nargs="+",
                    default=[0.0, 1e-6, 1e-4])
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args(argv)
    torch.set_num_threads(2)            # the e2e test's
    world = cs.backend_world(args.device)
    closed = {}
    for m in args.magnitudes:
        seeds = range(args.seeds) if m > 0 else [None]
        for seed in seeds:
            corr = world_correction(m, seed) if m > 0 else None
            res = drive(world, args.device, corr)
            closed.setdefault(m, []).append(res["loop_closures"] >= 1)
            print(json.dumps(dict(device=args.device, magnitude=m, seed=seed,
                                  **res)), flush=True)
    print(json.dumps(dict(device=args.device, at_tick=AT_TICK,
                          closed_runs={str(m): f"{sum(v)} of {len(v)}"
                                       for m, v in closed.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
