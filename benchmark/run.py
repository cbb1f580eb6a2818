"""Run one cell of BENCHMARK.json once, on the card, and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. Builds the cell's traffic and the program
from the seed, sets the program up (set-up ends at the first timed
tick), drives it for `--seconds`, checks what the window produced
against the plain reference (benchmark/check.py) and prints, as its last
lines on standard error, each compared number beside its limit, and as
the last line of standard output one JSON object: ``correct``,
``attempted`` and ``failed`` (ticks), ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer ones with ``--trace 1``),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``.

Without a CUDA card, or with fewer than the cell asks for, it exits
non-zero before any result; so it does when the process has loaded JAX,
its libraries or the JAX package once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

# one process with few threads: the host's share of a run stays steady
THREADS = 2
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(THREADS)
sys.path.insert(0, str(Path(__file__).resolve().parent))

import check as C  # noqa: E402
import harness as H  # noqa: E402

T_PROCESS = H.process_start()


def metrics_line(res: dict, cell: H.Cell, trace_data: dict | None) -> dict:
    """The metrics of the run: end-to-end ones from the window, or with a
    trace the per-layer readers' numbers (a reader that finds nothing is
    left out)."""
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace_data is None:
        values = {m["name"]: res[m["name"]] for m in cell.end_to_end}
    else:
        values = {}
        for name, read in H.readers(cell).items():
            v = read(trace_data)
            if v is not None:
                values[name] = v
    return {k: {"value": float(v), "unit": units[k]}
            for k, v in values.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(THREADS)
    cell = H.load_cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{found}", file=sys.stderr)
        return 2
    driver = H.load_module(H.ROOT / "drivers" / f"{cell.traffic['driver']}.py",
                           f"driver_{cell.traffic['driver']}")
    ctx = H.Context(cell=cell, seed=args.seed % 2 ** 63,
                    seconds=args.seconds, trace=bool(args.trace),
                    device=torch.device("cuda"), t_process=T_PROCESS)
    res = driver.run(ctx)

    loaded = H.forbidden_modules()
    if loaded:
        print(f"the run loaded {loaded}: the benchmark and the port may "
              "load neither JAX nor the JAX package", file=sys.stderr)
        return 3
    correct, rows = C.verdict(res["numbers"], cell.workload["limits"])
    widest = {k: v for k, v in res["numbers"].items() if k.endswith("_widest")}
    if widest:
        ctx.note(read_not_compared=widest)
    trace_data = ctx.trace_data
    device = dict(res["device"])
    if trace_data is not None:
        device.update(busy_s=trace_data["busy_s"],
                      window_s=trace_data["window_s"])
    line = dict(correct=correct and res["failed"] == 0,
                attempted=res["attempted"], failed=res["failed"],
                metrics=metrics_line(res, cell, trace_data), device=device)
    if trace_data is not None:
        line["breakdown"] = trace_data["breakdown"]
    line["checks"] = {k: {"value": v if math.isfinite(v) else str(v),
                          "limit": lim} for k, v, lim in rows}
    for k in ("card", "window_s", "records_taken",
              "checked_rolls", "checked_ticks"):
        if k in res:
            ctx.note(**{k: res[k]})
    for note in ctx.log:
        print(json.dumps(note), file=sys.stderr)
    for k, v, lim in rows:
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
