#!/usr/bin/env python
"""Live closed loop from TCP event streams through esvo_tpu_torch, with
the flags and behaviour of scripts/run_live.py.

Each camera is a TCP stream in io/live.py's packet framing (any driver
shim can emit it; ``esvo_tpu_torch.io.live.serve_event_stream`` replays a
recording); the port's EsvoSystem consumes fixed-capacity tick frames
exactly like a dataset replay, with an optional --live-view browser
dashboard (utils/live_view.py) of the debug maps and the status, whose
reset button resets the system. The system runs on the CUDA card; a
Python caller passes ``main(argv, device="cpu")`` for the CPU.

Example (terminal 1 replays a recording as two live senders):
    python - <<'PY'
    from esvo_tpu_torch.io.datasets import load_rpg_dataset
    from esvo_tpu_torch.io.live import serve_event_stream
    ev_l, ev_r, *_ = load_rpg_dataset("/data/rpg_bin")
    pl, _ = serve_event_stream(ev_l, port=7700, pace=1.0)
    pr, t = serve_event_stream(ev_r, port=7701, pace=1.0)
    t.join()
    PY
Terminal 2:
    python scripts/torch_run_live.py --left 127.0.0.1:7700 \
        --right 127.0.0.1:7701 --calib /data/rpg_calib --preset rpg
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from esvo_tpu_torch.geometry.camera import load_rig  # noqa: E402
from esvo_tpu_torch.io.live import LiveEventStream  # noqa: E402
from esvo_tpu_torch.runtime.config import (  # noqa: E402
    SystemConfig, with_overrides)
from esvo_tpu_torch.runtime.system import EsvoSystem  # noqa: E402
from esvo_tpu_torch.utils.live_view import LiveViewer  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--left", required=True, metavar="HOST:PORT")
    ap.add_argument("--right", required=True, metavar="HOST:PORT")
    ap.add_argument("--calib", required=True)
    ap.add_argument("--preset", default=None)
    ap.add_argument("--set", dest="overrides", action="append", default=[])
    ap.add_argument("--tick-rate-hz", type=float, default=None)
    ap.add_argument("--duration", type=float, default=None,
                    help="stop after this many stream seconds")
    ap.add_argument("--capacity", type=int, default=None)
    ap.add_argument("--frame-timeout", type=float, default=30.0)
    ap.add_argument("--out", default="trajectory_live.txt")
    ap.add_argument("--live-view", type=int, default=None, metavar="PORT",
                    help="serve a live browser dashboard of the debug maps "
                         "+ system status on this port (utils/live_view.py;"
                         " open http://localhost:PORT)")
    ap.add_argument("--quiet", action="store_true")
    return ap.parse_args(argv)


def main(argv=None, device=None):
    """Run the live loop until the streams end (or --duration); returns
    {ticks, status, stats}. `device`: ``cuda`` unless given."""
    args = parse_args(argv)
    rig = load_rig(args.calib, device=device)
    cfg = (SystemConfig.from_preset(args.preset) if args.preset
           else SystemConfig())
    if args.overrides:
        cfg = with_overrides(cfg, args.overrides)
    system = EsvoSystem(rig, cfg, emit_debug_maps=args.live_view is not None,
                        device=device)
    viewer = None
    if args.live_view is not None:
        viewer = LiveViewer(port=args.live_view,
                            on_reset=lambda: system.reset())
        if not args.quiet:
            print(f"[torch_run_live] view: http://localhost:{viewer.port}/")

    def connect(spec):
        host, _, port = spec.rpartition(":")
        return LiveEventStream(host or "127.0.0.1", int(port))

    left = connect(args.left)
    right = connect(args.right)
    try:
        t0 = left.first_time()
        t0r = right.first_time()
        if t0 is None or t0r is None:
            raise SystemExit("no events arrived on one of the streams")
        t0 = min(t0, t0r)
        tick = 1.0 / (args.tick_rate_hz or cfg.tracking.tracking_rate_hz)
        capacity = args.capacity or 4 * cfg.mapping.process_event_num
        if not args.quiet:
            print(f"[torch_run_live] first event t={t0:.3f}s, tick "
                  f"{tick * 1e3:.1f} ms, capacity {capacity}, device "
                  f"{system.device}")
        k = 0
        t_sync = t0
        wall0 = time.perf_counter()
        while True:
            t_sync += tick
            if args.duration and t_sync - t0 > args.duration:
                break
            fl = left.next_frame(t_sync, capacity,
                                 timeout=args.frame_timeout)
            fr = right.next_frame(t_sync, capacity,
                                  timeout=args.frame_timeout)
            if fl is None or fr is None:
                if not args.quiet:
                    print("[torch_run_live] frame timeout: stream stalled")
                break
            out = system.process_tick(
                float(t_sync), {k2: v for k2, v in fl.items()
                                if k2 != "dropped"},
                {k2: v for k2, v in fr.items() if k2 != "dropped"})
            k += 1
            if viewer is not None and "maps" in out:
                for name, img in out["maps"].items():
                    viewer.update(name, img)
                viewer.update_text(
                    "status", f"tick {k}  {out['status']}  "
                    f"map={out.get('map_points', 0)}")
            if not args.quiet and k % 100 == 0:
                rate = k / (time.perf_counter() - wall0)
                print(f"  tick {k} status={out['status']} "
                      f"map={out.get('map_points', 0)} ({rate:.1f} "
                      "ticks/s)")
            if left.eof and right.eof:
                break
        system.flush()
        system.save_trajectory(args.out)
        if not args.quiet:
            print(f"[torch_run_live] {k} ticks; trajectory -> {args.out}; "
                  f"buffer drops: L={left.dropped_oldest} "
                  f"R={right.dropped_oldest}")
    finally:
        left.close()
        right.close()
        if viewer is not None:
            viewer.close()
    return {"ticks": k, "status": system.status.value,
            "stats": system.stats}


if __name__ == "__main__":
    main()
