"""EventMatcher candidate-window overflow on a dense event stream, the
counterpart of scripts/measure_em_overflow.py on esvo_tpu_torch's
loaders (numpy only: its statistics equal the JAX script's).

The port's EventMatcher (mapping/event_matcher.py), like the JAX
package's, windows each left
event's same-polarity right candidates into K = max_candidates fixed
slots; in-window candidates beyond K are dropped AND counted
(window_overflow). The reference iterates every candidate
(core/EventMatcher.cpp:66-89), so the drop is a deviation whose size
must be measured, not assumed (VERDICT r4 #8).

This script computes the EXACT overflow statistics of the windowing on a
real event stream with plain searchsorted arithmetic (no device work):
for every left event, the number of right events of the same polarity
within +-time_threshold/2 is hi - lo on the per-polarity time-sorted
stream - identical to the device code's lo/hi (same searchsorted
semantics). Reports the distribution of in-window candidate counts and
the fraction of candidates lost at several K.

Usage:
    python3 scripts/torch_measure_em_overflow.py --dataset build/sim_campaign

(build/sim_campaign: scripts/torch_sim_campaign.py's default output.)
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="build/sim_campaign",
                    help="rpg-layout dataset dir (events_{left,right}.npz "
                         "or .txt)")
    ap.add_argument("--time-threshold", type=float, default=5e-5,
                    help="EventMatcherConfig.time_threshold")
    ap.add_argument("--ks", default="16,32,64,128")
    ap.add_argument("--max-events", type=int, default=None)
    args = ap.parse_args(argv)

    from esvo_tpu_torch.io.events import load_events_npz
    from esvo_tpu_torch.io.datasets import load_rpg_dataset

    npz_l = os.path.join(args.dataset, "events_left.npz")
    if os.path.exists(npz_l):
        ev_l = load_events_npz(npz_l)
        ev_r = load_events_npz(os.path.join(args.dataset,
                                            "events_right.npz"))
    else:
        ev_l, ev_r, _, _ = load_rpg_dataset(args.dataset, args.max_events)
    if args.max_events:
        sl = slice(0, args.max_events)
        tl, pl = ev_l.t[sl], ev_l.p[sl]
        tr, pr = ev_r.t[sl], ev_r.p[sl]
    else:
        tl, pl = ev_l.t, ev_l.p
        tr, pr = ev_r.t, ev_r.p

    half = args.time_threshold / 2.0
    counts = np.zeros(len(tl), np.int64)
    for pol in (True, False):
        sel_l = pl == pol
        t_r_pol = np.sort(tr[pr == pol])
        lo = np.searchsorted(t_r_pol, tl[sel_l] - half, side="left")
        hi = np.searchsorted(t_r_pol, tl[sel_l] + half, side="right")
        counts[sel_l] = hi - lo

    # per-(polarity, row-band) in-window counts — what the r5 matcher
    # actually windows (raw y as band proxy; rectification shifts rows
    # by less than a band on these nearly-rectified rigs)
    yl = ev_l.y if not args.max_events else ev_l.y[:args.max_events]
    yr = ev_r.y if not args.max_events else ev_r.y[:args.max_events]
    band_counts = np.zeros(len(tl), np.int64)
    T_BITS = np.int64(1) << 42
    for pol in (True, False):
        sel_l = pl == pol
        sel_r = pr == pol
        key_r = np.sort(yr[sel_r].astype(np.int64) * T_BITS
                        + (tr[sel_r] * 1e6).astype(np.int64))
        for db in (0,):   # the event's own band dominates
            kb = yl[sel_l].astype(np.int64) + db
            qlo = kb * T_BITS + ((tl[sel_l] - half) * 1e6).astype(np.int64)
            qhi = kb * T_BITS + ((tl[sel_l] + half) * 1e6).astype(np.int64)
            band_counts[sel_l] += (np.searchsorted(key_r, qhi, "right")
                                   - np.searchsorted(key_r, qlo, "left"))

    rate = len(tl) / max(tl[-1] - tl[0], 1e-9)
    out = {
        "events": int(len(tl)),
        "rate_ev_per_s": round(float(rate), 1),
        "time_threshold_s": args.time_threshold,
        "candidates_mean": round(float(counts.mean()), 2),
        "candidates_p50": int(np.percentile(counts, 50)),
        "candidates_p99": int(np.percentile(counts, 99)),
        "candidates_max": int(counts.max()),
    }
    total = int(counts.sum())
    for k in (int(s) for s in args.ks.split(",")):
        lost = int(np.maximum(counts - k, 0).sum())
        out[f"overflow_frac_K{k}"] = round(lost / max(total, 1), 6)
        out[f"events_truncated_frac_K{k}"] = round(
            float((counts > k).mean()), 6)
    # post-banding: slots per band = K // 2 (NB = 2 at the default
    # epipolar threshold 0.5)
    out["band_candidates_mean"] = round(float(band_counts.mean()), 2)
    out["band_candidates_p99"] = int(np.percentile(band_counts, 99))
    bt = int(band_counts.sum())
    for k in (int(s) for s in args.ks.split(",")):
        kb = max(k // 2, 1)
        lost = int(np.maximum(band_counts - kb, 0).sum())
        out[f"band_overflow_frac_K{k}"] = round(lost / max(bt, 1), 6)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
