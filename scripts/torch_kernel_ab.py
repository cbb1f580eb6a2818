"""Time K4-K7 (the tracker's LM scan, the regularization, block
matching's disparity scan, the fusion fold) and the paths they sit on,
for one checkout of the repository, on the card.

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
- ``k6``: block matching's disparity scan through
  ``block_matching.best_disparity`` (K6 on the card) at the rpg (1,000
  events, D = 40) and DSEC (10,000 events, D = 151, smoothed) presets on
  ``chip_smoke.bm_world``'s surfaces;
- ``k7``: ``fusion.fuse_frame`` at the rpg (4,000 candidates, radius 0)
  and DSEC (40,000, radius 1: the fuse stage of a DSEC rebuild) presets
  on ``chip_smoke.fuse_world``'s grid: device ms a call by kernel group
  (K7 by its profiler name, the sorts, the cummax of a rank, the rest)
  and launches a call;
- ``cycle``: one profiled rpg and DSEC mapping cycle
  (``chip_smoke.run_cycle``): wall and device-busy ms, launches, its
  heaviest kernels;
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


def measure_k6(cs, label: str, card: str, iters: int) -> None:
    for shape, preset, n, disp in (("rpg", cs.RPG, 1000, 8),
                                   ("dsec", cs.DSEC, 10000, 40)):
        bcfg = cs.SystemConfig.from_dict(preset).bm
        rig = cs.make_rig(shape, "cuda")
        H, W = rig.left.height, rig.left.width
        ts_l, ts_r, x, _ = cs.bm_world(rig, n, disp, seed=21)
        if bcfg.smooth_time_surface:
            ts_l = cs.tsf.gaussian_blur(ts_l, 5)
            ts_r = cs.tsf.gaussian_blur(ts_r, 5)
        ui = torch.clamp(torch.floor(x[:, 0]).long(), 0, W - 1)
        vi = torch.clamp(torch.floor(x[:, 1]).long(), 0, H - 1)
        hy, hx = (bcfg.patch_size_y - 1) // 2, (bcfg.patch_size_x - 1) // 2
        t = cs.timed(lambda: cs.bm.best_disparity(
            ts_l, ts_r, ui, vi, bcfg.min_disparity, bcfg.max_disparity, hy,
            hx, "slice"), iters)
        _line(dict(ab="k6", label=label, card=card, shape=shape, events=n,
                   disparities=bcfg.max_disparity - bcfg.min_disparity + 1,
                   kernel_ms=t["ms"], call_ms=t["call_ms"],
                   timing=t["timing"]))


def _by_group(cs, fn, iters: int) -> dict:
    """Device ms a call of fn by kernel group, and launches a call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    # K7 by its profiler name, torch.cummax's scan, torch.sort's radix
    # sort kernels (named ...Sort... / ...sort...)
    groups = {"k7": cs.KERNEL_NAMES["fuse"], "cummax":
              "scan_innermost_dim_with_indices", "sort": "sort"}
    ms = dict.fromkeys([*groups, "other"], 0.0)
    launches = 0
    for e in prof.key_averages():
        if e.device_type != cs.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        key = next((g for g, pat in groups.items()
                    if pat in e.key.lower()), "other")
        ms[key] += us / 1e3 / iters
        launches += e.count
    return dict(ms=ms, total_ms=sum(ms.values()), launches=launches / iters)


def measure_k7(cs, label: str, card: str, iters: int) -> None:
    for shape, preset, m in (("rpg", cs.RPG, 4000), ("dsec", cs.DSEC, 40000)):
        cfg = cs.SystemConfig.from_dict(preset)
        rig = cs.make_rig(shape, "cuda")
        H, W = rig.left.height, rig.left.width
        radius = cfg.fusion.fusion_radius
        grid, cand = cs.fuse_world(H, W, m, seed=31 + radius)
        fcfg = cs.fu.FusionConfig(
            ls_norm="Tdist", fusion_radius=radius,
            max_candidates_per_pixel=cfg.fusion.max_candidates_per_pixel)
        g = _by_group(cs, lambda: cs.fu.fuse_frame(grid, cand, rig.left,
                                                   fcfg), iters)
        _line(dict(ab="k7", label=label, card=card, shape=shape,
                   candidates=m, radius=radius, **g))


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
                       "device_launches", "top")},
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
    measure_k6(cs, label, card, args.iters)
    measure_k7(cs, label, card, args.iters)
    measure_k5(cs, label, card, args.iters)
    measure_k4(cs, label, card, args.iters)
    if not args.skip_loops:
        measure_loops(cs, label, card)
    _line(dict(ab="done", label=label, card=card,
               seconds=time.perf_counter() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
