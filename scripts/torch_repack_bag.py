#!/usr/bin/env python
"""Offline bag repacketizer on esvo_tpu_torch's rosbag reader and writer
(the events_repacking_helper counterpart; same flags as
scripts/repack_bag.py).

The reference's dataset-prep workflow (events_repacking_helper/README.md:
17-44): filter hot pixels, then rewrite the event streams as fixed-period
(1 ms = 1000 Hz) dvs_msgs/EventArray messages so the downstream 100 Hz
time-surface node always has fresh events
(EventMessageEditor.cpp:95-121). This tool does both without ROS.

  python scripts/torch_repack_bag.py in.bag out.bag \
      --left /davis/left/events --right /davis/right/events \
      --period-ms 1 --filter-hot-pixels
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from esvo_tpu_torch.io.events import EventArray  # noqa: E402
from esvo_tpu_torch.io.rosbag import (  # noqa: E402
    BagReader, hot_pixel_mask, write_events_bag)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--left", default="/davis/left/events")
    ap.add_argument("--right", default="/davis/right/events")
    ap.add_argument("--period-ms", type=float, default=1.0,
                    help="output message period (reference: 1 ms)")
    ap.add_argument("--filter-hot-pixels", action="store_true")
    ap.add_argument("--hot-sigma", type=float, default=5.0)
    ap.add_argument("--height", type=int, default=260)
    ap.add_argument("--width", type=int, default=346)
    args = ap.parse_args(argv)

    bag = BagReader(args.input)
    streams = {}
    for topic in (args.left, args.right):
        ev = bag.events(topic)
        n0 = len(ev)
        if args.filter_hot_pixels:
            keep = hot_pixel_mask(ev, args.height, args.width,
                                  args.hot_sigma)
            ev = EventArray(t=ev.t[keep], x=ev.x[keep], y=ev.y[keep],
                            p=ev.p[keep], t_offset=ev.t_offset)
        print(f"[repack] {topic}: {n0} -> {len(ev)} events")
        streams[topic] = ev
    write_events_bag(args.output, streams,
                     period=args.period_ms * 1e-3,
                     height=args.height, width=args.width)
    print(f"[repack] wrote {args.output} "
          f"({os.path.getsize(args.output) / 1e6:.1f} MB)")
    return streams


if __name__ == "__main__":
    main()
