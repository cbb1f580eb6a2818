"""Time K4 (the tracker's LM scan) and K5 (the regularization) and the
paths they sit on, for one checkout of the repository, on the card.

    python3 scripts/torch_kernel_ab.py [--root CHECKOUT] [--label NAME]
        [--skip-loops]

It imports ``chip_smoke`` from CHECKOUT (default: this script's
repository), so the same script measures two checkouts: run it once a
checkout, in turns (parent, change, change, parent) in one session on
one card, and compare the lines. It prints one JSON line a measurement,
each with the card's name and power limit:
- ``k5``: the K5 device time at the rpg (180x240, r = 5) and DSEC
  (480x640, r = 20) presets on ``chip_smoke.regularize_world``'s grid;
- ``k4``: the K4 device time on ``chip_smoke.track_world``'s problem at
  both rigs (2000 map points): the preset (batch 300, 10 rounds), batch
  32, 1 round, and a map of 600 points in the 2000 slots (6 empty
  rounds);
- ``cycle``: one profiled rpg and DSEC mapping cycle
  (``chip_smoke.run_cycle``): wall and device-busy ms, launches;
- ``resident``: the rpg resident loop (``chip_smoke.run_resident``):
  ms a tick, ticks/s, the replay's ms a tick and kernels a roll.
Only the functions that both checkouts' ``chip_smoke.py`` share are
called. Needs a card: without one it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch


def _line(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def measure_k5(cs, label: str, card: str, iters: int) -> None:
    for shape, preset, (H, W) in (("rpg", cs.RPG, (180, 240)),
                                  ("dsec", cs.DSEC, (480, 640))):
        rcfg = cs.SystemConfig.from_dict(preset).regularizer
        grid = cs.regularize_world(H, W, seed=9)
        t = cs.timed(lambda: cs.regularize(grid, rcfg), iters)
        _line(dict(ab="k5", label=label, card=card, shape=shape,
                   radius=rcfg.radius, norm=rcfg.ls_norm,
                   valid=int(grid.occupied.sum()), kernel_ms=t["ms"],
                   call_ms=t["call_ms"], timing=t["timing"]))


def measure_k4(cs, label: str, card: str, iters: int) -> None:
    for shape in ("rpg", "dsec"):
        rig = cs.make_rig(shape, "cuda")
        prob, cam, cfg = cs.track_world(rig, 2000, seed=7)
        out = {}
        for name, over, n_valid in (("b300_k10", {}, None),
                                    ("b32_k10", dict(batch_size=32), None),
                                    ("b300_k1", dict(max_iteration=1), None),
                                    ("map600_b300_k10", {}, 600)):
            p = prob
            if n_valid is not None:
                p = prob.replace(point_valid=torch.arange(
                    2000, device="cuda") < n_valid)
            args = [a.contiguous() for a in (
                p.R, p.t, p.T_world_ref, p.points, p.point_valid,
                p.ts_negative, p.grad_u, p.grad_v, cam.params.P, cam.mask)]
            kw = dict(batch_size=cfg.batch_size,
                      max_iteration=cfg.max_iteration,
                      huber=cfg.ls_norm == "Huber",
                      huber_threshold=cfg.huber_threshold,
                      lm_damping=cfg.lm_damping)
            kw.update(over)
            t = cs.timed(lambda: cs.track.track_solve(*args, **kw), iters)
            out[name] = t["ms"]
        _line(dict(ab="k4", label=label, card=card, shape=shape,
                   kernel_ms=out))


def measure_loops(cs, label: str, card: str) -> None:
    cfgs = {n: cs.SystemConfig.from_dict(d)
            for n, d in (("rpg", cs.RPG), ("dsec", cs.DSEC))}
    rigs = {n: cs.make_rig(n, "cuda") for n in cfgs}
    for name in ("rpg", "dsec"):
        scene, ticks, frames = cs.make_stream(name, rigs[name])
        recs = cs.run_cycle(name, rigs[name], cfgs[name], scene,
                            ticks[:cs.SCENES[name]["cycle_ticks"]], frames,
                            "cuda")
        prof = [r for r in recs if "profile" in r][0]["profile"]["cycle"]
        recs = [r for r in recs if "profile" not in r]
        _line(dict(ab="cycle", label=label, card=card, shape=name,
                   **{k: prof[k] for k in (
                       "wall_ms", "profiled_wall_ms", "device_busy_ms",
                       "idle_share", "idle_share_unprofiled",
                       "device_launches")},
                   estimate_ms=[r["estimate_ms"] for r in recs],
                   rebuild_ms=[r["rebuild_ms"] for r in recs],
                   valid=[r["valid"] for r in recs],
                   fusions=[r["fusions"] for r in recs]))
    scene, ticks, evs = cs.make_events("rpg", rigs["rpg"])
    cs.log = lambda obj: None           # run_resident's own lines
    res = cs.run_resident(rigs["rpg"], cfgs["rpg"], scene, ticks, evs)
    d = res["profiled_dispatch"]
    _line(dict(ab="resident", label=label, card=card,
               ms_per_tick=res["ms_per_tick"], ticks_per_s=res["ticks_per_s"],
               replay_ms_per_tick=d["replay_ms_per_tick"],
               kernels_per_roll=d["kernels_per_roll"],
               idle_share_unprofiled=d["idle_share_unprofiled"],
               ate_m=res["ate_m"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default=None)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--skip-loops", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label = args.label or Path(args.root).resolve().name
    card = cs.card_line()
    t0 = time.perf_counter()
    cs._build.build([info["source"].rsplit("/", 1)[1]
                     for info in cs.KERNELS.values()])
    measure_k5(cs, label, card, args.iters)
    measure_k4(cs, label, card, args.iters)
    if not args.skip_loops:
        measure_loops(cs, label, card)
    _line(dict(ab="done", label=label, card=card,
               seconds=time.perf_counter() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
