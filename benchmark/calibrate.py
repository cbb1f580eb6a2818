"""The readings the limits of a cell's check are set from, on the card.

    python3 benchmark/calibrate.py --workload rpg.resident \\
        --seeds 101-112 --control 101-103 --fault 101-103 --seconds 4

For each seed, in one process: the cell's run with a short window
(set-up, window, check) gives the program's numbers against the plain
reference; for the seeds named by ``--control`` the same recorded steps
are also run by the reference in TF32 (float32 matmuls and convolutions
at a 10-bit mantissa, the nearest precision below the configuration's
float32 with TF32 off) in the program's place, against the reference at
full float32: the control, which has to come out not correct; for the
seeds named by ``--fault``, each fault of check.FAULTS planted in the
reference put in the program's place, likewise. One JSON line a seed;
the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import check as C  # noqa: E402
import harness as H  # noqa: E402


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def reading(cell_name: str, seed: int, seconds: float, control: bool,
            device=None, faults: bool = False) -> dict:
    """One seed's run of the cell and, with `control`, the control's
    numbers on the same recorded steps; with `faults`, each fault's."""
    import torch
    cell = H.load_cell(cell_name)
    driver = H.load_module(H.ROOT / "drivers"
                           / f"{cell.traffic['driver']}.py",
                           f"driver_{cell.traffic['driver']}")
    ctx = H.Context(cell=cell, seed=seed, seconds=seconds, trace=False,
                    device=torch.device(device or "cuda"),
                    t_process=time.perf_counter())
    res = driver.run(ctx)
    out = dict(seed=seed, attempted=res["attempted"], failed=res["failed"],
               program=res["numbers"],
               program_correct=C.verdict(res["numbers"],
                                         cell.workload["limits"])[0])
    runs = (["tf32"] if control else []) + (sorted(C.FAULTS) if faults
                                             else [])
    for mode in runs:
        num = driver.check_records(res["records"], res["params"], cell,
                                   ctx.device, control=mode)
        key = "control" if mode == "tf32" else mode
        out.update({key: num, key + "_correct":
                    C.verdict(num, cell.workload["limits"])[0]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    ctl = set(seeds(args.control)) if args.control else set()
    bad = set(seeds(args.fault)) if args.fault else set()
    for s in seeds(args.seeds):
        print(json.dumps(reading(args.workload, s, args.seconds, s in ctl,
                                 faults=s in bad)), flush=True)
    found = H.forbidden_modules()
    if found:
        print(f"loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
