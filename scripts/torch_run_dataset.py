#!/usr/bin/env python
"""Dataset replay through esvo_tpu_torch: the launch-file analogue of the
reference, with the flags and behaviour of scripts/run_dataset.py.

Loads a dataset (rpg text directory, MVSEC or DSEC hdf5, or a rosbag
v2.0), a calibration (or the bag's camera_info topics) and the
reference-format parameter YAMLs, runs the port's EsvoSystem (the closed
loop, or with ground-truth poses under --mode mvstereo, as the JAX
runner does), writes the TUM trajectory and reports ATE / RPE when
ground truth is present. --ba adds the sliding-window bundle adjustment
(runtime/backend_loop.py), --loop-closure the loop-closure + pose-graph
backend (runtime/pose_graph_loop.py), --live-view the browser dashboard
(utils/live_view.py), --trace DIR the program's spans and counters
(utils/profiling.py: DIR/spans.json, a Chrome trace, and DIR/summary.txt).
The system runs on the CUDA card; a Python caller passes
``main(argv, device="cpu")`` for the CPU.

--devices N (> 1) runs N SPMD ranks (parallel/sharding.py run_ranks):
every rank reads the same inputs and runs EsvoSystem(mesh=...) with the
mapping event axis (and BA / the pose graph, with --ba /
--loop-closure) sharded over the ranks; only rank 0 writes files, prints
and serves the live view. On CUDA the ranks talk over NCCL, one card
each, so N cards must be visible; on the CPU (``device="cpu"``) they are
gloo processes.

Example:
  python scripts/torch_run_dataset.py --dataset /data/rpg_bin \
      --calib /ref/esvo_core/calib/rpg \
      --mapping-yaml /ref/esvo_core/cfg/mapping/mapping_rpg.yaml \
      --tracking-yaml /ref/esvo_core/cfg/tracking/tracking_rpg.yaml \
      --ts-yaml /ref/esvo_core/cfg/time_surface/ts_parameters.yaml \
      --out traj.txt
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from esvo_tpu_torch.backend.loop_closure import (  # noqa: E402
    LoopClosureConfig)
from esvo_tpu_torch.eval.trajectory import (  # noqa: E402
    ate_rmse, interpolate_pose, rpe_stats, save_tum)
from esvo_tpu_torch.geometry.camera import load_rig  # noqa: E402
from esvo_tpu_torch.io import datasets, rosbag  # noqa: E402
from esvo_tpu_torch.io.events import (  # noqa: E402
    EventArray, load_events_npz, save_events_npz)
from esvo_tpu_torch.io.stream import EventFrameStream  # noqa: E402
from esvo_tpu_torch.parallel.sharding import (  # noqa: E402
    make_mesh, run_ranks)
from esvo_tpu_torch.runtime.backend_loop import BackendLoop  # noqa: E402
from esvo_tpu_torch.runtime.checkpoint import (  # noqa: E402
    load_checkpoint, save_checkpoint)
from esvo_tpu_torch.runtime.config import (  # noqa: E402
    SystemConfig, with_overrides)
from esvo_tpu_torch.runtime.pose_graph_loop import (  # noqa: E402
    PoseGraphLoop)
from esvo_tpu_torch.runtime.resident import (  # noqa: E402
    ResidentLoop, TimestampDiscontinuity)
from esvo_tpu_torch.runtime.system import (  # noqa: E402
    EsvoSystem, SystemStatus)
from esvo_tpu_torch.utils import profiling  # noqa: E402
from esvo_tpu_torch.utils.live_view import LiveViewer  # noqa: E402


def parse_args(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_argument_group("dataset source (pick one)")
    src.add_argument("--dataset", help="rpg-format directory "
                     "(events_left.txt / events_right.txt / groundtruth.txt)")
    src.add_argument("--mvsec", help="MVSEC data hdf5 (stereo davis)")
    src.add_argument("--mvsec-gt", help="MVSEC ground-truth hdf5")
    src.add_argument("--dsec", nargs=2, metavar=("LEFT_H5", "RIGHT_H5"),
                     help="DSEC left/right event hdf5 files")
    src.add_argument("--bag", help="rosbag v2.0 with stereo "
                     "dvs_msgs/EventArray topics (read without ROS)")
    ap.add_argument("--bag-left-topic", default="/davis/left/events")
    ap.add_argument("--bag-right-topic", default="/davis/right/events")
    ap.add_argument("--bag-gt-topic", default=None,
                    help="geometry_msgs/PoseStamped ground-truth topic")
    ap.add_argument("--calib",
                    help="calibration dir holding left.yaml/right.yaml; "
                         "optional with --bag when the bag carries "
                         "camera_info topics")
    ap.add_argument("--bag-caminfo-left",
                    default="/davis/left/camera_info")
    ap.add_argument("--bag-caminfo-right",
                    default="/davis/right/camera_info")
    ap.add_argument("--preset", help="shipped preset name (configs/) or a "
                    "native-schema YAML; overridden by the --*-yaml flags")
    ap.add_argument("--set", dest="overrides", action="append",
                    metavar="SECTION.FIELD=VALUE",
                    help="override one config field (repeatable)")
    ap.add_argument("--mapping-yaml", help="reference mapping cfg YAML")
    ap.add_argument("--tracking-yaml", help="reference tracking cfg YAML")
    ap.add_argument("--ts-yaml", help="reference time-surface cfg YAML")
    ap.add_argument("--mode", choices=["closed", "mvstereo"],
                    default="closed",
                    help="closed = full mapping<->tracking loop; mvstereo = "
                         "GT poses (requires ground truth)")
    ap.add_argument("--tick-rate-hz", type=float, default=None,
                    help="sync-tick rate (default: the config's "
                         "tracking_rate_hz)")
    ap.add_argument("--start", type=float, default=0.0,
                    help="seconds into the stream to start")
    ap.add_argument("--duration", type=float, default=None,
                    help="seconds to process (default: whole stream)")
    ap.add_argument("--capacity", type=int, default=None,
                    help="events per tick frame (default: 4x "
                         "PROCESS_EVENT_NUM)")
    ap.add_argument("--max-events", type=int, default=None,
                    help="cap loaded events (smoke runs)")
    ap.add_argument("--cache", action="store_true",
                    help="cache parsed events as .npz next to the source "
                         "(rpg txt and --bag)")
    ap.add_argument("--out", default="trajectory.txt",
                    help="TUM trajectory output path")
    ap.add_argument("--debug-maps",
                    help="directory: dump invDepth/stdVar/age/cost/"
                         "reprojection images every mapping cycle")
    ap.add_argument("--live-view", type=int, default=None, metavar="PORT",
                    help="serve a live browser dashboard of the debug "
                         "maps + system status on this port "
                         "(utils/live_view.py; open http://localhost:PORT)")
    ap.add_argument("--save-depth-maps",
                    help="directory: per-mapping-cycle depth-map txt files")
    ap.add_argument("--depth-dump-every", type=int, default=1,
                    help="dump every Nth mapping publish")
    ap.add_argument("--global-map-out",
                    help="write the voxel-downsampled global point cloud "
                         "(xyz text) here")
    ap.add_argument("--checkpoint-every", type=float, default=None,
                    help="seconds between checkpoints")
    ap.add_argument("--checkpoint-dir", default="ckpt")
    ap.add_argument("--resume", help="checkpoint dir to resume from")
    ap.add_argument("--roll", type=int, default=0,
                    help="ticks a process_ticks roll (0 = one tick at a "
                         "time); mapping runs once per roll")
    ap.add_argument("--resident", type=int, default=0, metavar="ROLLS",
                    help="device-resident loop (runtime/resident.py): this "
                         "many rolls of --roll ticks a dispatch while "
                         "WORKING; bootstrap and resets on the host path. "
                         "Requires --roll > 1 and one device")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard the mapping event axis (and BA / the pose "
                         "graph) over N SPMD ranks, one CUDA card each "
                         "(EsvoSystem(mesh=...); PROCESS_EVENT_NUM must be "
                         "divisible by N)")
    ap.add_argument("--loop-closure", action="store_true",
                    help="loop-closure + pose-graph backend: time-surface "
                         "descriptor revisit detection, ICP verification, "
                         "SE(3) pose-graph optimization "
                         "(runtime/pose_graph_loop.py)")
    ap.add_argument("--loop-every", type=int, default=5,
                    help="mapping cycles per loop-closure keyframe")
    ap.add_argument("--lc-min-similarity", type=float, default=None,
                    help="loop-closure descriptor cosine gate (default "
                         "LoopClosureConfig.min_similarity)")
    ap.add_argument("--lc-set", dest="lc_overrides", action="append",
                    default=[], metavar="FIELD=VALUE",
                    help="override one LoopClosureConfig field "
                         "(repeatable)")
    ap.add_argument("--ba", action="store_true",
                    help="sliding-window bundle adjustment backend "
                         "(runtime/backend_loop.py)")
    ap.add_argument("--ba-window", type=int, default=6)
    ap.add_argument("--ba-every", type=int, default=2,
                    help="mapping cycles per BA keyframe")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="record the program's spans and counters "
                         "(utils/profiling.py) and write them at exit: "
                         "DIR/spans.json (a Chrome trace; open it in "
                         "Perfetto) and DIR/summary.txt")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    if args.devices < 1:
        ap.error(f"--devices {args.devices}: at least 1")
    if args.devices > 1 and not dist.is_initialized() \
            and torch.device("cuda" if device is None else device).type \
            == "cuda" and torch.cuda.device_count() < args.devices:
        ap.error(f"--devices {args.devices}: {torch.cuda.device_count()} "
                 "CUDA card(s) visible; one NCCL rank a card")
    return args


def load_events(args):
    """Returns (ev_left, ev_right, gt_times, gt_poses)."""
    if args.dataset:
        return datasets.load_rpg_dataset(args.dataset, args.max_events,
                                         cache=args.cache)
    if args.mvsec:
        ev_l, ev_r = datasets.load_mvsec_stereo(args.mvsec, args.max_events)
        gt_t, gt_T = (None, None)
        if args.mvsec_gt:
            gt_t, gt_T = datasets.load_mvsec_gt_poses(args.mvsec_gt, "left")
            gt_t = gt_t - ev_l.t_offset  # same session origin as events
        return ev_l, ev_r, gt_t, gt_T
    if args.dsec:
        ev_l, ev_r = datasets.load_dsec_stereo(args.dsec[0], args.dsec[1],
                                               args.max_events)
        return ev_l, ev_r, None, None
    if args.bag:
        if not args.cache:
            return rosbag.load_stereo_bag(
                args.bag, args.bag_left_topic, args.bag_right_topic,
                args.bag_gt_topic, args.max_events)
        cl, cr = args.bag + ".left.npz", args.bag + ".right.npz"
        cg = args.bag + ".gt.npz"
        fresh = all(os.path.exists(c)
                    and os.path.getmtime(c) >= os.path.getmtime(args.bag)
                    for c in (cl, cr))
        if fresh:
            ev_l, ev_r = load_events_npz(cl), load_events_npz(cr)
            gt_t, gt_T = (None, None)
            if args.bag_gt_topic and os.path.exists(cg):
                g = np.load(cg)
                gt_t, gt_T = g["t"], g["T"]
        else:
            ev_l, ev_r, gt_t, gt_T = rosbag.load_stereo_bag(
                args.bag, args.bag_left_topic, args.bag_right_topic,
                args.bag_gt_topic)
            save_events_npz(cl, ev_l)
            save_events_npz(cr, ev_r)
            if gt_t is not None:
                np.savez(cg, t=gt_t, T=gt_T)
        if args.max_events is not None:
            m = args.max_events
            cut = lambda e: EventArray(t=e.t[:m], x=e.x[:m], y=e.y[:m],
                                       p=e.p[:m], t_offset=e.t_offset)
            ev_l, ev_r = cut(ev_l), cut(ev_r)
        return ev_l, ev_r, gt_t, gt_T
    raise SystemExit(
        "no dataset source given (--dataset/--mvsec/--dsec/--bag)")


def lc_config(args) -> LoopClosureConfig | None:
    """The LoopClosureConfig of --lc-min-similarity and --lc-set (None
    for the defaults)."""
    if args.lc_min_similarity is None and not args.lc_overrides:
        return None
    import yaml
    kw = {}
    if args.lc_min_similarity is not None:
        kw["min_similarity"] = args.lc_min_similarity
    names = {fld.name for fld in dataclasses.fields(LoopClosureConfig)}
    for ov in args.lc_overrides:
        key, sep, val = ov.partition("=")
        if not sep or key not in names:
            raise SystemExit(f"--lc-set: unknown field {ov!r}; "
                             f"fields: {sorted(names)}")
        kw[key] = yaml.safe_load(val)
    return dataclasses.replace(LoopClosureConfig(), **kw)


def interpolate_gt(gt_times, gt_poses, t):
    """GT pose at time t (translation lerp + SO(3)-projected rotation
    lerp)."""
    return interpolate_pose(np.asarray(gt_times), np.asarray(gt_poses), t)


def main(argv=None, device=None):
    """Run the replay; returns the result dict (ticks, wall_s, stats, and
    ate_rmse_m / rpe_* for a closed run with ground truth). `device`:
    where the system runs, ``cuda`` unless given. With --devices N > 1
    it starts N ranks and returns rank 0's result. With --trace DIR the
    tracer records the run (each rank its own; rank 0 writes DIR), and
    DIR is written even when the run fails."""
    args = parse_args(argv, device)
    if args.devices > 1:
        if args.resident:
            raise SystemExit("--resident requires --roll > 1, --mode closed "
                             "and a single device")
        if not dist.is_initialized():
            return run_ranks(main, args.devices, argv, device=device)
    if args.trace is None:
        return replay(args, device)
    profiling.enable()
    try:
        return replay(args, device)
    finally:
        profiling.disable()
        records = profiling.take()
        if not dist.is_initialized() or dist.get_rank() == 0:
            summary = profiling.export(records, args.trace)
            if not args.quiet:
                print(f"[torch_run_dataset] spans -> {args.trace}\n"
                      f"{summary}")


def replay(args, device):
    """The replay of `args` (main's, after the ranks have started)."""
    mesh = make_mesh(args.devices) if args.devices > 1 else None
    # rank 0 alone writes files, prints and serves the live view
    lead = mesh is None or dist.get_rank() == 0
    live = args.live_view is not None
    args.quiet = args.quiet or not lead
    if not lead:
        args.debug_maps = args.save_depth_maps = None
        args.global_map_out = args.live_view = None
        args.checkpoint_every = None
    if args.calib:
        rig = load_rig(args.calib, device=device)
    elif args.bag:
        rig = rosbag.load_rig_from_bag(args.bag, args.bag_caminfo_left,
                                       args.bag_caminfo_right, device=device)
    else:
        raise SystemExit("--calib is required (or use --bag with "
                         "camera_info topics)")
    if args.preset and not (args.mapping_yaml or args.tracking_yaml
                            or args.ts_yaml):
        cfg = SystemConfig.from_preset(args.preset)
    else:
        cfg = SystemConfig.from_yaml(args.mapping_yaml, args.tracking_yaml,
                                     args.ts_yaml)
    if args.overrides:
        cfg = with_overrides(cfg, args.overrides)

    ev_l, ev_r, gt_times, gt_poses = load_events(args)
    if args.mode == "mvstereo" and gt_times is None:
        raise SystemExit("--mode mvstereo requires ground-truth poses")

    system = EsvoSystem(rig, cfg,
                        emit_debug_maps=bool(args.debug_maps
                                             or args.live_view is not None),
                        mesh=mesh, device=device)
    viewer = None
    ctl = {"params": [], "reset": False}
    ctl_lock = threading.Lock()
    if args.live_view is not None:
        def _on_param(s):
            # validated against the config schema now (a bad field is
            # rejected at the request); applied between chunks with a
            # system reset, the dynamic_reconfigure analogue
            with_overrides(system.cfg, [s])
            with ctl_lock:
                ctl["params"].append(s)
            return f"queued {s} (applies with a system reset)"

        def _on_reset():
            with ctl_lock:
                ctl["reset"] = True

        viewer = LiveViewer(port=args.live_view, on_param=_on_param,
                            on_reset=_on_reset)
        if not args.quiet:
            print(f"[torch_run_dataset] live view: "
                  f"http://localhost:{viewer.port}/")
    backend = None
    if args.ba:
        backend = BackendLoop(system, keyframe_every=args.ba_every,
                              window=args.ba_window, mesh=mesh)
    pose_graph = None
    if args.loop_closure:
        pose_graph = PoseGraphLoop(system, keyframe_every=args.loop_every,
                                   lc_config=lc_config(args), mesh=mesh)
    tick_rate = args.tick_rate_hz or cfg.tracking.tracking_rate_hz
    tick = 1.0 / tick_rate
    t0 = args.start
    if args.resume:
        load_checkpoint(system, args.resume)
        if backend is not None:
            backend.load(args.resume)
        if pose_graph is not None:
            pose_graph.load(args.resume)
        # fast-forward past the checkpoint: replaying earlier ticks would
        # trip the dt < 0 watchdog and reset the restored state
        if system.last_tick_time is not None \
                and t0 <= system.last_tick_time:
            t0 = system.last_tick_time
            if not args.quiet:
                print(f"[torch_run_dataset] resume: fast-forward to "
                      f"t={t0:.3f} s (checkpointed tick)")

    t_end_stream = float(min(ev_l.t[-1], ev_r.t[-1]))
    t1 = min(t_end_stream,
             t0 + args.duration if args.duration else t_end_stream)
    sync_times = np.arange(t0 + tick, t1, tick)
    capacity = args.capacity or 4 * cfg.mapping.process_event_num
    if not args.quiet:
        print(f"[torch_run_dataset] {len(ev_l)} + {len(ev_r)} events, "
              f"{len(sync_times)} ticks @ {tick_rate:g} Hz, "
              f"capacity {capacity}, device {system.device}")

    # streaming framer with a prefetch thread (host framing overlaps the
    # device's work)
    stream_l = EventFrameStream(ev_l.slice_time(t0, t1), sync_times,
                                capacity, prefetch=2)
    stream_r = EventFrameStream(ev_r.slice_time(t0, t1), sync_times,
                                capacity, prefetch=2)
    if args.debug_maps:
        os.makedirs(args.debug_maps, exist_ok=True)

    last_ckpt = t0
    wall0 = time.perf_counter()
    R = max(args.roll, 0)
    res_rolls = max(args.resident, 0)
    use_resident = res_rolls >= 1 and R > 1 and args.mode == "closed"
    if args.resident and not use_resident:
        raise SystemExit("--resident requires --roll > 1, --mode closed "
                         "and a single device")
    chunk = R * res_rolls if use_resident else R
    if chunk > 1:
        pairs = zip(stream_l.rolls(chunk), stream_r.rolls(chunk))
    else:
        pairs = zip(stream_l, stream_r)
    resident = None

    def host_chunk(tl, fl, fr):
        """Host-path processing of one chunk (bootstrap / fallback):
        R-tick rolls where the chunk holds them, one tick at a time
        otherwise."""
        out = None
        ts = np.atleast_1d(tl)
        n = len(ts)
        k2 = 0
        while k2 < n:
            if R > 1 and n - k2 >= R:
                sl = slice(k2, k2 + R)
                gts = None
                if args.mode == "mvstereo":
                    gts = np.stack([interpolate_gt(gt_times, gt_poses, t)
                                    for t in ts[sl]])
                out = system.process_ticks(
                    ts[sl], {key: v[sl] for key, v in fl.items()},
                    {key: v[sl] for key, v in fr.items()},
                    gt_poses=gts, do_mapping=True)
                k2 += R
            else:
                if n == 1 and np.ndim(tl) == 0:
                    ts_k, f1, f2 = float(tl), fl, fr
                else:
                    ts_k = float(ts[k2])
                    f1 = {key: v[k2] for key, v in fl.items()}
                    f2 = {key: v[k2] for key, v in fr.items()}
                gt = None
                if args.mode == "mvstereo":
                    gt = interpolate_gt(gt_times, gt_poses, ts_k)
                out = system.process_tick(ts_k, f1, f2, gt_pose=gt)
                k2 += 1
        return out

    k = 0
    n_dumpable = 0
    for (tl, fl), (_, fr) in pairs:
        fl = {key: v for key, v in fl.items() if key != "dropped"}
        fr = {key: v for key, v in fr.items() if key != "dropped"}
        step = len(np.atleast_1d(tl))
        params, do_reset = [], False
        if viewer is not None:
            # apply queued live-view control between chunks
            with ctl_lock:
                params, ctl["params"] = ctl["params"], []
                do_reset, ctl["reset"] = ctl["reset"], False
        if live and mesh is not None:
            # every rank applies rank 0's control, so the ranks stay in step
            box = [(params, do_reset)]
            dist.broadcast_object_list(box, src=0, group=mesh.get_group())
            params, do_reset = box[0]
        if params or do_reset:
            if resident is not None:
                resident.finish()
                resident = None
            if params:
                if not args.quiet:
                    print(f"[torch_run_dataset] live reconfigure: {params}")
                system.reconfigure(with_overrides(system.cfg, params))
            elif do_reset:
                if not args.quiet:
                    print("[torch_run_dataset] live reset")
                system.reset()
        if use_resident and system.status == SystemStatus.WORKING \
                and step == chunk:
            # the device-resident path: one dispatch a chunk
            if resident is None:
                resident = ResidentLoop(system, ticks_per_roll=R,
                                        rolls_per_dispatch=res_rolls)
                resident.start()
            try:
                resident.run(tl, fl, fr)
                out = resident.sync()
            except TimestampDiscontinuity:
                # reset on the host path
                resident.finish()
                resident = None
                out = host_chunk(tl, fl, fr)
            else:
                if out.pop("degraded", False):
                    # every recent cycle collapsed: re-bootstrap
                    resident.finish()
                    resident = None
                    system._degrade()
        else:
            if resident is not None:
                resident.finish()
                resident = None
            out = host_chunk(tl, fl, fr)
        t_sync = sync_times[min(k + step - 1, len(sync_times) - 1)]
        if backend is not None:
            backend.maybe_update(out)
        if pose_graph is not None:
            pg_stats = pose_graph.maybe_update(out)
            if pg_stats and not args.quiet:
                if "pg_cost_final" in pg_stats:
                    print(f"  loop closure: kf {pg_stats['lc_candidate']} "
                          f"sim={pg_stats['lc_similarity']:.3f} "
                          f"edges={pg_stats['pg_num_loop_edges']}")
                elif "lc_inlier_fraction" in pg_stats:
                    # cleared the descriptor gate, failed the ICP
                    print(f"  loop candidate rejected: "
                          f"kf {pg_stats['lc_candidate']} "
                          f"sim={pg_stats['lc_similarity']:.3f} "
                          f"inliers={pg_stats['lc_inlier_fraction']:.2f} "
                          f"mean_d={pg_stats['lc_mean_dist']:.3f} "
                          f"corr_t={pg_stats.get('lc_corr_t', -1):.2f} "
                          f"corr_r={pg_stats.get('lc_corr_r', -1):.2f}")
        if args.debug_maps and "maps" in out:
            _dump_maps(args.debug_maps, k, out["maps"])
        if viewer is not None:
            if "maps" in out:
                for name, img in out["maps"].items():
                    viewer.update(name, img)
            viewer.update_text(
                "status",
                f"tick {k + step}/{len(sync_times)}  "
                f"{out['status']}  map={out.get('map_points', 0)}")
        if args.save_depth_maps and ("bm_stats" in out
                                     or "sgm_points" in out):
            n_dumpable += 1
            if n_dumpable % max(args.depth_dump_every, 1) == 0:
                system.save_depth_map(args.save_depth_maps)
        if args.checkpoint_every and \
                t_sync - last_ckpt >= args.checkpoint_every:
            if resident is not None:
                # a checkpoint snapshots the system's host state: hand the
                # device state back first (the loop re-enters next chunk)
                resident.finish()
                resident = None
            save_checkpoint(system, args.checkpoint_dir)
            if backend is not None:
                backend.save(args.checkpoint_dir)
            if pose_graph is not None:
                pose_graph.save(args.checkpoint_dir)
            last_ckpt = t_sync
        if not args.quiet and (k + step) % 100 < step:
            wall = time.perf_counter() - wall0
            print(f"  tick {k + step}/{len(sync_times)} "
                  f"status={out['status']} map={out.get('map_points', 0)} "
                  f"({(k + step) / wall:.1f} ticks/s)")
        k += step
    if resident is not None:
        resident.finish()
    system.flush()
    if viewer is not None:
        viewer.update_text("status", "done")
        viewer.close()

    wall = time.perf_counter() - wall0
    if lead:
        system.save_trajectory(args.out)
    if not args.quiet:
        print(f"[torch_run_dataset] {len(sync_times)} ticks in {wall:.1f} s "
              f"({len(sync_times) / max(wall, 1e-9):.1f} ticks/s); "
              f"trajectory -> {args.out}")
        print(f"  stats: {system.stats}")
    if args.global_map_out:
        gm = system.global_map()
        np.savetxt(args.global_map_out, gm, fmt="%.6f")
        if not args.quiet:
            print(f"  global map: {len(gm)} voxels -> "
                  f"{args.global_map_out}")

    result = {"ticks": len(sync_times), "wall_s": wall,
              "status": system.status.value, "stats": system.stats}
    if backend is not None:
        result["ba_runs"] = backend.num_ba_runs
        result["ba_rejected_corrections"] = \
            backend.num_rejected_corrections
    if pose_graph is not None:
        result["loop_closures"] = pose_graph.num_loop_closures
        result["loop_edges"] = pose_graph.loop_edges()
        # the pose graph redistributes drift over the whole keyframe
        # chain; apply_world_correction only moves the live pose, so the
        # optimized trajectory is a separate artifact
        pg_times, pg_T = pose_graph.optimized_trajectory()
        if len(pg_times):
            pg_out = args.out + ".pose_graph.txt"
            if lead:
                save_tum(pg_out, pg_times, pg_T)
            result["pose_graph_trajectory"] = pg_out
            if gt_times is not None:
                result["pg_ate_rmse_m"] = float(ate_rmse(
                    pg_times, pg_T, gt_times, gt_poses, align=True))
    if gt_times is not None and args.mode == "closed":
        t_est, T_est = system.trajectory()
        ate = ate_rmse(t_est, T_est, gt_times, gt_poses, align=True)
        result["ate_rmse_m"] = float(ate)
        rpe_t, rpe_r = rpe_stats(t_est, T_est, gt_times, gt_poses)
        result["rpe_trans_rmse_m"] = rpe_t
        result["rpe_rot_rmse_rad"] = rpe_r
        if not args.quiet:
            print(f"  ATE RMSE vs GT: {ate:.4f} m; "
                  f"RPE {rpe_t:.4f} m / {rpe_r:.4f} rad per step")
    return result


def _dump_maps(outdir, k, maps):
    try:
        import imageio.v2 as imageio
        writer = lambda p, img: imageio.imwrite(p, img)
        ext = "png"
    except ImportError:
        writer = lambda p, img: np.save(p, img)
        ext = "npy"
    for name, img in maps.items():
        writer(os.path.join(outdir, f"{name}_{k:06d}.{ext}"), img)


if __name__ == "__main__":
    main()
