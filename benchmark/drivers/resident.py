"""The resident replay: a dataset replayed as fast as the card goes, as
``scripts/torch_run_dataset.py --resident`` drives it.

Set-up: the scene from the seed, the host path (``process_ticks``, rolls
of ``roll`` ticks) from INITIALIZATION through the SGM bootstrap to
WORKING, ``ResidentLoop.start``, then ``warm_dispatches`` dispatches (the
first captures the roll's CUDA graph). The window: dispatches of
``rolls_per_dispatch`` rolls issued back to back, ``run`` then ``sync``
each, the next dispatch's inputs framed on a thread meanwhile, over the
stream's laps; ``ticks_per_s`` is every tick of every dispatch over the
time to the last ``sync``. A traced run adds CUDA
events around every graph replay in the window, then profiles
``profiled_dispatches`` dispatches.

The check records the dispatches that start first after moments drawn
from the seed: the loop's state before each roll (``stage`` is wrapped),
the roll's scores, the program's own render of both surfaces after each
roll (its K3, as ``run`` renders the dispatch's last left surface), its
packed output and the state after; the reference replays each roll from
the state before it, each tick from the program's pose at the tick
before.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import check as C
import harness as H
import devtrace as T


def _clone(state):
    return state.map(torch.clone)


class Recorder:
    """Wraps the loop's ``stage`` (an instance attribute over the method)
    for one dispatch: the state before each roll, the roll's scores and,
    once the roll has run, the program's render of both surfaces at its
    last tick."""

    def __init__(self, loop):
        self.loop, self.rolls = loop, []

    def render(self) -> tuple:
        loop = self.loop
        return loop.system.cycle.render_pair(
            loop.state.ts_left, loop.state.ts_right, loop.inputs.t_syncs[-1])

    def __enter__(self):
        loop, orig = self.loop, self.loop.stage

        def stage(t_syncs, ev_left, ev_right, scores=None):
            if self.rolls:
                self.rolls[-1]["rendered"] = self.render()
            before = _clone(loop.state)
            orig(t_syncs, ev_left, ev_right, scores)
            self.rolls.append(dict(before=before,
                                   scores=loop.inputs.scores.clone()))
        loop.stage = stage
        return self

    def __exit__(self, *exc):
        del self.loop.stage
        if exc[0] is None:
            if len(self.rolls) != self.loop.R:
                raise RuntimeError(
                    f"ResidentLoop.run staged {len(self.rolls)} of its "
                    f"{self.loop.R} rolls through `stage`, which the "
                    "benchmark's check wraps (PERF.md lists what it reads)")
            self.rolls[-1]["rendered"] = self.render()


def _bad_ticks(summary: dict, RK: int, working) -> int:
    poses = summary.get("poses")
    if (summary.get("status") != working.value or summary.get("degraded")
            or poses is None or len(poses) != RK):
        return RK
    return int((~np.isfinite(np.asarray(poses)).reshape(RK, -1).all(1)).sum())


def run(ctx: H.Context) -> dict:
    cell, dev, tr = ctx.cell, ctx.device, ctx.cell.traffic
    K, R = tr["roll"], tr["rolls_per_dispatch"]
    RK = K * R
    P = H.program()
    params, stream = H.make_stream(cell, ctx.seed)
    ctx.note(seam=H.scene_mod.check_seam(stream),
             events_per_s_a_camera=stream.events_per_s(),
             dropped_a_tick=[float(f["dropped"].mean())
                             for f in stream.frames])
    rig = H.scene_mod.build_rig(params, P.camera, torch.float32, dev)
    system = P.EsvoSystem(rig, P.SystemConfig.from_dict(
        cell.config["system"]), device=dev, seed=ctx.seed)

    # the host path from INITIALIZATION to WORKING, a roll at a time
    i = stream.start
    while system.status != P.WORKING:
        if i - stream.start >= tr["bootstrap_ticks"]:
            raise RuntimeError(f"not WORKING after {i - stream.start} ticks "
                               "of bootstrap")
        system.process_ticks(*stream.ticks_at(i, K))
        i += K
    loop = P.ResidentLoop(system, K, R)
    loop.start()
    for _ in range(tr["warm_dispatches"]):
        loop.run(*stream.ticks_at(i, RK))
        loop.sync()
        i += RK
    H.require_internals(system, loop)

    spans = []
    if ctx.trace:
        step = loop.step

        def timed_step():
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            out = step()
            e1.record()
            spans.append((e0, e1))
            return out
        loop.step = timed_step

    moments = H.sample_times(ctx.seed, cell.workload["check"]["dispatches"],
                             ctx.seconds)
    records, n_ticks, failed = [], 0, 0
    # the next dispatch's inputs are framed on a thread while this one
    # runs, as the runner's EventFrameStream prefetches them
    pool = ThreadPoolExecutor(max_workers=1)
    H.settle()
    t0 = H.sync(dev)
    setup_s = t0 - ctx.t_process
    ahead = pool.submit(stream.ticks_at, i, RK)
    while True:
        now = time.perf_counter() - t0
        batch = ahead.result()
        ahead = pool.submit(stream.ticks_at, i + RK, RK)
        if len(records) < len(moments) and now >= moments[len(records)]:
            with Recorder(loop) as rec:
                out = loop.run(*batch)
            records.append(dict(rolls=rec.rolls, after=_clone(loop.state),
                                outs=out["outs"].clone(),
                                ts_left=out["ts_left"].clone(), batch=batch))
        else:
            loop.run(*batch)
        failed += _bad_ticks(loop.sync(), RK, P.WORKING)
        n_ticks += RK
        i += RK
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    wall = H.sync(dev) - t0
    ahead.result()
    pool.shutdown()

    res = dict(attempted=n_ticks, failed=failed, setup_s=setup_s,
               ticks_per_s=n_ticks / wall, window_s=wall,
               records_taken=len(records),
               card=H.nvidia_power_limit())
    if ctx.trace:
        del loop.step
        if len(spans) * K != n_ticks:
            raise RuntimeError(
                f"{len(spans)} graph replays for {n_ticks} ticks: "
                "ResidentLoop.run no longer replays through `step`, where "
                "the benchmark times each replay")
        replay_ms = sum(a.elapsed_time(b) for a, b in spans)
        n_valid = int(loop.state.ref_ok.sum())
        ctx.trace_data = dict(
            replay_ms_per_tick=replay_ms / n_ticks,
            idle_outside_replays=100.0 * (1.0 - replay_ms / 1e3 / wall),
            ticks_per_replay=K)
        n_prof = tr["profiled_dispatches"]
        batches = [stream.ticks_at(i + k * RK, RK) for k in range(n_prof)]
        i += n_prof * RK
        with T.profiled() as prof:
            tp0 = H.sync(dev)
            for batch in batches:
                with T.span("ResidentLoop.run"):
                    loop.run(*batch)
                with T.span("ResidentLoop.sync"):
                    loop.sync()
            tp1 = H.sync(dev)
        ops = T.device_ops(prof)
        cfg = cell.config["system"]
        dep = cfg["depth"]
        ctx.trace_data.update(
            ops=ops, profiled_ticks=n_prof * RK, window_s=tp1 - tp0,
            busy_s=T.busy_s(ops),
            breakdown=T.breakdown([ops], T.host_spans(
                prof, ("ResidentLoop.run", "ResidentLoop.sync"))),
            track_points=cfg["tracker"]["max_registration_points"],
            track_valid=min(n_valid,
                            cfg["tracker"]["max_registration_points"]),
            track_batch=cfg["tracker"]["batch_size"],
            track_rounds=cfg["tracker"]["max_iteration"],
            lm_events=cfg["mapping"]["process_event_num"],
            lm_window=(dep["patch_size_y"], dep["patch_size_x"],
                       dep["window_margin"]))
    res["device"] = H.device_info(dev, cell.chips)
    del loop, system, spans
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    res["numbers"] = check_records(records, params, cell, dev)
    res["checked_rolls"] = sum(len(r["rolls"]) for r in records)
    res["records"], res["params"] = records, params
    return res


def roll_outputs(ref, cycle, rec: dict, r: int, dev, mode: str,
                 fault: str | None = None) -> dict:
    """The reference's roll r of a recorded dispatch, from the program's
    state before it, under the matmul precision `mode` (and with
    `fault`, a name of check.FAULTS, planted): its poses (each
    tick solved from the program's pose at the tick before: a near-tied
    LM accept test that one side takes otherwise then moves one solve,
    not the roll's chain), the surfaces it renders at the roll's last
    tick, its mapping estimates (on the program's poses) and its map."""
    roll = rec["rolls"][r]
    t_syncs, fl, fr = rec["batch"]
    nK = len(t_syncs) // len(rec["rolls"])
    sl = slice(r * nK, (r + 1) * nK)
    pick = lambda d: {k: np.asarray(v)[sl] for k, v in d.items()}
    out = rec["outs"][r].to(dev)
    follow = (out[:16 * nK].reshape(nK, 4, 4),
              out[17 * nK:18 * nK] > 0.5)
    with C.precision(mode), C.fault(fault), torch.no_grad():
        new, poses, est, _ = ref.step.roll(
            cycle, C.to_plain(roll["before"], ref), C.events(pick(fl), dev),
            C.events(pick(fr), dev),
            torch.as_tensor(np.asarray(t_syncs[sl], np.float32), device=dev),
            roll["scores"], follow)
        surfaces = cycle.render_pair(new.ts_left, new.ts_right,
                                     float(np.float32(t_syncs[sl][-1])))
    return dict(poses=poses.double().cpu().numpy(), surfaces=surfaces,
                est=est, grid=new.grid, extra=[])


def program_outputs(ref, cycle, rec: dict, r: int) -> dict:
    """Roll r as the program ran it, in roll_outputs' form: the guarded
    poses of its packed output, the surfaces it rendered after the roll
    (and, against them and against the left surface that ``run`` rendered
    on a dispatch's last roll, the reference's render of the program's
    state after it), the estimates it wrote into the window and its
    map."""
    rolls = rec["rolls"]
    after = rolls[r + 1]["before"] if r + 1 < len(rolls) else rec["after"]
    nK = len(rec["batch"][0]) // len(rolls)
    poses = rec["outs"][r, :16 * nK].double().cpu().numpy().reshape(nK, 4,
                                                                    4)
    t_last = float(np.float32(rec["batch"][0][(r + 1) * nK - 1]))
    state = C.to_plain(after, ref)
    with C.precision("highest"), torch.no_grad():
        kept = cycle.render_pair(state.ts_left, state.ts_right, t_last)
    rendered = rolls[r]["rendered"]
    extra = list(zip(rendered, kept))
    if r + 1 == len(rolls):
        extra.append((rec["ts_left"], kept[0]))
    slot = int(rolls[r]["before"].hist_slot)
    return dict(poses=poses, surfaces=rendered,
                est=state.history.map(lambda a: a[slot]), grid=state.grid,
                extra=extra)


def numbers(prog: dict, want: dict) -> dict:
    """The compared numbers of one roll: `prog` in the program's place
    against the reference's `want` (both in roll_outputs' form)."""
    pose_m, pose_rad = C.pose_gaps(prog["poses"], want["poses"])
    pairs = list(zip(prog["surfaces"], want["surfaces"])) + prog["extra"]
    return dict(surface_levels=C.surface_gap(*pairs), pose_m=pose_m,
                pose_rad=pose_rad,
                estimates_share=C.estimates_share(prog["est"], want["est"]),
                map_share=C.map_share(prog["grid"], want["grid"]))


def check_records(records, params, cell, dev, control: str | None = None
                  ) -> dict:
    """Each number over the recorded rolls (check.reduce): the program
    against the reference; with `control` "tf32", the reference in TF32
    in the program's place; with a name of check.FAULTS, the reference
    with that fault planted in the program's place."""
    ref, cycle = H.reference_cycle(params, cell, dev)
    out: dict = {}
    for rec in records:
        for r in range(len(rec["rolls"])):
            want = roll_outputs(ref, cycle, rec, r, dev, "highest")
            prog = (program_outputs(ref, cycle, rec, r) if control is None
                    else roll_outputs(ref, cycle, rec, r, dev, "tf32")
                    if control == "tf32"
                    else roll_outputs(ref, cycle, rec, r, dev, "highest",
                                      control))
            C.merge(out, numbers(prog, want))
    return C.reduce(out)
