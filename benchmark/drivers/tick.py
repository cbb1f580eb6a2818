"""The live path: ``EsvoSystem.process_tick`` one tick at a time, one
caller in a closed loop, as ``scripts/torch_run_live.py`` and the
runner's default drive it; with ``known_poses`` each tick carries its
ground-truth pose (tracking bypassed: the mapper on poses from another
source, as the reference's MVStereo evaluation runs it).

Set-up: the scene from the seed, ticks until the system is WORKING (the
SGM bootstrap on the first mapping ticks), then ``warm_ticks`` more. The
window: ticks back to back; a tick's latency runs from the call to a
``torch.cuda.synchronize()`` after it. A traced run then profiles
``profiled_ticks`` ticks, one profile a tick.

The check records ticks drawn from the seed (mapping ticks and ticks
without a cycle): the system's state before the tick (its surfaces, the
window of estimates, the pose table and the registration points and
scores the tick drew, through its public ``select_ref_points`` and
``draw_ref_scores``) and its outputs after; the reference runs each tick
from that state.
"""
from __future__ import annotations

import time

import numpy as np
import torch

import check as C
import harness as H
import devtrace as T


class Recorder:
    """Wraps the system's ``draw_ref_scores`` and ``select_ref_points``
    (instance attributes over the methods) for one tick: the scores the
    tick drew and the map it selected its points from."""

    def __init__(self, system):
        self.system, self.got = system, {}

    def __enter__(self):
        sy, draw, select = (self.system, self.system.draw_ref_scores,
                            self.system.select_ref_points)

        def draw_scores():
            self.got["scores"] = draw()
            return self.got["scores"]

        def select_points(pts_world, pt_valid):
            self.got["ref_map"] = (pts_world, pt_valid)
            return select(pts_world, pt_valid)
        sy.draw_ref_scores, sy.select_ref_points = draw_scores, select_points
        return self

    def __exit__(self, *exc):
        del self.system.draw_ref_scores, self.system.select_ref_points


def snapshot(system) -> dict:
    """The host-side state a tick starts from (the device tensors are
    not changed in place by a tick: references suffice)."""
    S = system.pose_table_size
    return dict(ts=(system.ts_state_left, system.ts_state_right),
                history=system.history, slot=int(system.cycle.hist_slot),
                T_world_frame=np.array(system.T_world_frame),
                T_world_cur=np.array(system.T_world_cur),
                pose_times=list(system.pose_times[-S - 1:]),
                pose_list=list(system.pose_list[-S - 1:]),
                consec_rejects=int(system._consec_rejects),
                pose_table_size=S, status=system.status.value)


def record_tick(system, t, fl, fr, gt, snap: dict, out: dict) -> dict:
    mapped = "map_estimates" in out
    S = snap["pose_table_size"]
    rec = dict(snap, t=t, fl=fl, fr=fr, gt=gt, mapped=mapped,
               surfaces=(out["ts_left"], out["ts_right"]),
               ts_after=(system.ts_state_left, system.ts_state_right),
               T_after=np.array(system.T_world_cur),
               pose_times_after=list(system.pose_times[-S - 1:]),
               pose_list_after=list(system.pose_list[-S - 1:]))
    if mapped:
        rec.update(est=system.history.map(lambda a: a[snap["slot"]]),
                   grid=system.grid)
    return rec


def _tick_inputs(stream, i: int):
    t, fl, fr = stream.ticks_at(i, 1)
    return (float(t[0]), {k: v[0] for k, v in fl.items()},
            {k: v[0] for k, v in fr.items()})


def run(ctx: H.Context) -> dict:
    cell, dev, tr = ctx.cell, ctx.device, ctx.cell.traffic
    known = tr["known_poses"]
    P = H.program()
    params, stream = H.make_stream(cell, ctx.seed)
    ctx.note(seam=H.scene_mod.check_seam(stream),
             events_per_s_a_camera=stream.events_per_s(),
             dropped_a_tick=[float(f["dropped"].mean())
                             for f in stream.frames])
    rig = H.scene_mod.build_rig(params, P.camera, torch.float32, dev)
    system = P.EsvoSystem(rig, P.SystemConfig.from_dict(
        cell.config["system"]), device=dev, seed=ctx.seed)

    def tick(i: int, rec: dict | None = None):
        t, fl, fr = _tick_inputs(stream, i)
        gt = stream.gt_pose(t) if known else None
        if rec is None:
            return system.process_tick(t, fl, fr, gt_pose=gt), (t, fl, fr,
                                                                 gt)
        with Recorder(system) as r:
            out = system.process_tick(t, fl, fr, gt_pose=gt)
        rec.update(r.got)
        return out, (t, fl, fr, gt)

    i = stream.start
    while system.status != P.WORKING:
        if i >= tr["bootstrap_ticks"]:
            raise RuntimeError(f"not WORKING after {i} ticks of bootstrap")
        tick(i)
        i += 1
    for _ in range(tr["warm_ticks"]):
        tick(i)
        i += 1
    H.require_internals(system)

    chk = cell.workload["check"]
    moments = list(H.sample_times(ctx.seed, chk["mapping_ticks"]
                                  + chk["other_ticks"], ctx.seconds))
    want_map = [k < chk["mapping_ticks"] for k in np.random.default_rng(
        [ctx.seed, 11]).permutation(len(moments))]
    records, lat, mapping, failed = [], [], [], 0
    H.settle()
    t0 = H.sync(dev)
    setup_s = t0 - ctx.t_process
    while True:
        now = time.perf_counter() - t0
        due = (len(records) < len(moments) and now >= moments[len(records)]
               and system.last_mapping_time is not None
               and _maps_next(system, stream, i) == want_map[len(records)])
        snap = snapshot(system) if due else None
        extra = {} if due else None
        a = time.perf_counter()
        out, (t, fl, fr, gt) = tick(i, extra)
        lat.append(H.sync(dev) - a)
        mapping.append("map_estimates" in out)
        if out["status"] != P.WORKING.value or \
                not np.isfinite(system.T_world_cur).all():
            failed += 1
        if due:
            records.append(dict(record_tick(system, t, fl, fr, gt, snap,
                                            out), **extra))
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    wall = H.sync(dev) - t0
    lat_ms = np.asarray(lat) * 1e3
    res = dict(attempted=len(lat), failed=failed, setup_s=setup_s,
               tick_p50_ms=float(np.percentile(lat_ms, 50)),
               tick_p99_ms=float(np.percentile(lat_ms, 99)),
               window_s=wall, checked_ticks=len(records),
               card=H.nvidia_power_limit())
    if ctx.trace:
        ctx.trace_data = profile_ticks(ctx, system, tick, i, lat_ms,
                                       np.asarray(mapping), params)
    res["device"] = H.device_info(dev, cell.chips)
    del system
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    res["numbers"] = check_records(records, params, cell, dev)
    res["records"], res["params"] = records, params
    return res


def _maps_next(system, stream, i: int) -> bool:
    """Whether process_tick schedules a mapping cycle on tick i."""
    period = 1.0 / system.cfg.mapping.mapping_rate_hz
    return stream.tick_time(i) - system.last_mapping_time >= period - 1e-9


def profile_ticks(ctx, system, tick, i: int, lat_ms, mapping, params):
    """``profiled_ticks`` ticks, each under its own profile: launches,
    device busy time and wall a tick, K5 and K2 device time, the grid K5
    was given on the mapping ticks (recomputed by the reference), and
    the breakdown over all of them; the traced window is the profiled
    ticks' walls."""
    tr, dev = ctx.cell.traffic, ctx.device
    ticks, groups, spans, k5_grids = [], [], [], []
    for _ in range(tr["profiled_ticks"]):
        snap = snapshot(system)
        extra: dict = {}
        with T.profiled() as prof:
            a = H.sync(dev)
            with T.span("process_tick"):
                out, (t, fl, fr, gt) = tick(i, extra)
            with T.span("synchronize"):
                wall = H.sync(dev) - a
        ops = T.device_ops(prof)
        mapped = "map_estimates" in out
        ticks.append(dict(mapped=mapped, launches=len(ops), wall_s=wall,
                          busy_s=T.busy_s(ops),
                          k5=T.kernel_s(ops, "regularize_kernel<"),
                          k2=T.kernel_s(ops, "lm_kernel<")))
        if mapped:
            k5_grids.append(dict(record_tick(system, t, fl, fr, gt, snap,
                                             out), **extra))
        groups.append(ops)
        spans += T.host_spans(prof, ("process_tick", "synchronize"))
        i += 1
    cfg = ctx.cell.config["system"]
    dep, reg = cfg["depth"], cfg["regularizer"]
    k5_work = [regularize_given(rec, params, ctx.cell, dev)
               for rec in k5_grids]
    walls = lat_ms[mapping] / 1e3
    return dict(
        ticks=ticks,
        map_tick_wall_s=float(np.median(walls)) if walls.size else None,
        busy_s=sum(t["busy_s"] for t in ticks),
        window_s=sum(t["wall_s"] for t in ticks),
        breakdown=T.breakdown(groups, spans), k5_work=k5_work,
        k5_radius=reg["radius"], k5_tdist=reg["ls_norm"] != "l2",
        lm_events=cfg["mapping"]["process_event_num"],
        lm_window=(dep["patch_size_y"], dep["patch_size_x"],
                   dep["window_margin"]))


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

def tick_outputs(ref, cycle, rec: dict, dev, mode: str,
                 given: list | None = None, fault: str | None = None
                 ) -> dict:
    """The reference's tick from the program's state before it, under the
    matmul precision `mode` (and with `fault`, a name of check.FAULTS,
    planted): both surfaces, the pose after the guard and, on a mapping
    tick, the estimates and the map, made on the program's poses after
    the tick (as the resident check makes them: a tracker solve that
    parts from the reference's on a near-tied accept test is the pose
    numbers' to read, not the map's)."""
    with C.precision(mode), C.fault(fault), torch.no_grad():
        ts_l, ts_r = (C.to_plain(s, ref) for s in rec["ts"])
        ts_l = ref.step.tsf.insert_events(ts_l, C.events(rec["fl"], dev))
        ts_r = ref.step.tsf.insert_events(ts_r, C.events(rec["fr"], dev))
        s_l, s_r = cycle.render_pair(ts_l, ts_r, float(rec["t"]))
        host = dict(pose_times=list(rec["pose_times"]),
                    pose_list=list(rec["pose_list"]),
                    T_world_cur=rec["T_world_cur"],
                    consec_rejects=rec["consec_rejects"])
        if rec["gt"] is not None:
            T = np.asarray(rec["gt"])
        else:
            pts, ok = rec["ref_map"]
            T = ref.step.tracked_pose(cycle, s_l, rec["T_world_frame"],
                                      rec["T_world_cur"], pts, ok,
                                      rec["scores"])
        ref.step.record_pose(cycle.cfg, host, rec["t"], T)
        out = dict(surfaces=(s_l, s_r), pose=np.asarray(host["T_world_cur"]))
        if rec["mapped"]:
            followed = dict(pose_times=list(rec["pose_times_after"]),
                            pose_list=list(rec["pose_list_after"]),
                            T_world_cur=rec["T_after"], consec_rejects=0)
            got = ref.step.mapping_step(
                cycle, followed, s_l, s_r, C.events(rec["fl"], dev),
                C.to_plain(rec["history"], ref), rec["slot"],
                rec["pose_table_size"], given)
            if got is not None:
                out.update(est=got[0], grid=got[2])
    return out


def program_outputs(ref, cycle, rec: dict) -> dict:
    """The tick as the program ran it, in tick_outputs' form: the
    surfaces it rendered, and (against the same) the reference's render
    of the surface state the program kept after the tick."""
    with C.precision("highest"), torch.no_grad():
        kept = cycle.render_pair(*(C.to_plain(s, ref)
                                   for s in rec["ts_after"]),
                                 float(rec["t"]))
    out = dict(surfaces=rec["surfaces"], pose=rec["T_after"],
               extra=list(zip(kept, rec["surfaces"])))
    if rec["mapped"]:
        out.update(est=C.to_plain(rec["est"], ref),
                   grid=C.to_plain(rec["grid"], ref))
    return out


def numbers(prog: dict, want: dict) -> dict:
    pose_m, pose_rad = C.pose_gaps(prog["pose"], want["pose"])
    pairs = list(zip(prog["surfaces"], want["surfaces"])) \
        + prog.get("extra", [])
    res = dict(surface_levels=C.surface_gap(*pairs),
               pose_m=pose_m, pose_rad=pose_rad)
    if "est" in prog:
        if "est" not in want:
            return dict(res, estimates_share=1.0, map_share=1.0)
        res.update(estimates_share=C.estimates_share(prog["est"],
                                                     want["est"]),
                   map_share=C.map_share(prog["grid"], want["grid"]))
    return res


def check_records(records, params, cell, dev, control: str | None = None):
    """Each number over the recorded ticks (check.reduce): the program
    against the reference; with `control` "tf32", the reference in TF32
    in the program's place; with a name of check.FAULTS, the reference
    with that fault planted in the program's place."""
    ref, cycle = H.reference_cycle(params, cell, dev)
    out: dict = {}
    for rec in records:
        want = tick_outputs(ref, cycle, rec, dev, "highest")
        prog = (program_outputs(ref, cycle, rec) if control is None
                else tick_outputs(ref, cycle, rec, dev, "tf32")
                if control == "tf32"
                else tick_outputs(ref, cycle, rec, dev, "highest",
                                  fault=control))
        C.merge(out, numbers(prog, want))
    return C.reduce(out)


def regularize_given(rec: dict, params, cell, dev) -> dict:
    """The grid K5 was given on a profiled mapping tick, recomputed by
    the reference from the same tick: its valid centres and close
    pairs."""
    from workcount import close_pairs
    ref, cycle = H.reference_cycle(params, cell, dev)
    given: list = []
    tick_outputs(ref, cycle, rec, dev, "highest", given)
    if not given:
        return {}
    g = given[0]
    H_, W_ = g.inv_depth.shape
    return dict(valid=int(g.occupied.sum()), H=H_, W=W_,
                pairs=close_pairs(g.occupied, g.inv_depth, g.variance,
                                  cell.config["system"]["regularizer"][
                                      "radius"]))
