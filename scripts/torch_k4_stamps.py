"""Where K4's time goes: clock64 stamps in an instrumented copy of
esvo_tpu_torch/csrc/track.cu, on the card.

    python3 scripts/torch_k4_stamps.py [--rig rpg|dsec] [--iters N]

The package's source stays as it is: this script writes a copy with
stamps (thread 0 records clock64() at the phase boundaries of every
round) under build/k4_stamps/, builds it with the package's nvcc flags
and launches it on ``chip_smoke.track_world``'s problem (2000 map
points): the preset (batch 300, 10 rounds), batch 32, and a map of 600
points in the 2000 slots (6 empty rounds). It prints one JSON line a
case with the median cycles a round of each phase (thread 0's pass 1,
its warp's transpose, the barrier that waits for the slowest warp, the
serial algebra and its four parts, the barrier that publishes the trial
warp, pass 2, the second reduction and barrier, the accept, the
end-of-round barrier),
the prologue's cycles, the whole launch's cycles, the SM clock
(nvidia-smi) and the card's name and power limit. Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STRIDE = 10       # stamps a round
# (anchor line in track.cu, stamp index inserted after it; -1: before it)
ANCHORS = [
    ("const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;", "0"),
    ("any_valid(p, cur, batch_start(p, 0, B, num_batches), B, tid));", "1"),
    ("const int start = batch_start(p, it, B, num_batches);", "RB + 0"),
    ("red[warp * NSUM + lane] = warp_sums(acc, lane);\n      __syncthreads();",
     None),
    ("residual_warp(Rtry, ttry, s_try);", "RB + 4"),
    ("red[warp * NSUM + lane] = warp_sums(acc_try, lane);\n"
     "      __syncthreads();", None),
    ("accept ? sqrtf(sums[1] / fmaxf(sums[2], 1.0f)) : rms_cur;", "RB + 8"),
    ("nonempty = __syncthreads_or(any_valid(p, nxt, next, B, tid));",
     "RB + 9"),
]
PHASES = ["pass1", "warp_sums1", "barrier1", "algebra", "barrier2", "pass2",
          "sums2_barrier3", "accept", "barrier4"]
# the algebra's parts: warp 0's block sums and thread 0's read of them,
# the damped 6x6 step, the Cayley update with its Newton-Schulz steps, the
# trial warp (two more Newton-Schulz steps)
ALGEBRA = ["algebra_sums", "algebra_step", "algebra_update",
           "algebra_trial_warp"]


def stamped_source() -> str:
    s = (ROOT / "esvo_tpu_torch/csrc/track.cu").read_text()
    head = ("__device__ long long g_stamps[8192];\n"
            "#define STAMP(i) do { if (threadIdx.x == 0 && (i) < 8192) "
            "g_stamps[i] = clock64(); } while (0)\n"
            "#define RB (2 + it * 10)\n")
    s = s.replace("#define FULL 0xffffffffu\n",
                  "#define FULL 0xffffffffu\n" + head, 1)
    for anchor, idx in ANCHORS:
        if s.count(anchor) != 1:
            raise RuntimeError(f"track.cu changed: anchor {anchor!r}")
        if idx is not None:
            s = s.replace(anchor, f"{anchor}\nSTAMP({idx});")
    # the two reductions: stamp before the transpose, after it and after
    # its barrier
    for name, base in (("acc", 1), ("acc_try", 6)):
        line = f"red[warp * NSUM + lane] = warp_sums({name}, lane);"
        s = s.replace(
            f"{line}\n      __syncthreads();",
            f"STAMP(RB + {base});\n{line}\n"
            + (f"STAMP(RB + {base + 1});\n" if base == 1 else "")
            + "      __syncthreads();\n"
            + f"STAMP(RB + {base + (2 if base == 1 else 1)});")
    # inside the serial algebra (thread 0), at 4096 + 4 it + k
    for k, anchor in enumerate(("rms_cur = sqrtf(lin[1] / fmaxf(lin[2], "
                                "1.0f));", "damped_step(lin, lam, dx);",
                                "newton_schulz2(Rtry);")):
        if s.count(anchor) != 1:
            raise RuntimeError(f"track.cu changed: anchor {anchor!r}")
        s = s.replace(anchor, f"{anchor}\nSTAMP(4096 + 4 * it + {k});")
    s = s.replace("__syncthreads();\n\n      // the trial cost",
                  "__syncthreads();\nSTAMP(RB + 5);\n\n      // the trial "
                  "cost", 1)
    s += ("\nextern \"C\" int esvo_track_stamps(long long* host) {\n"
          "  return (int)cudaMemcpyFromSymbol(host, g_stamps, "
          "sizeof(g_stamps));\n}\n"
          "extern \"C\" int esvo_track_stamps_clear() {\n"
          "  void* at = nullptr;\n"
          "  cudaError_t err = cudaGetSymbolAddress(&at, g_stamps);\n"
          "  if (err != cudaSuccess) return (int)err;\n"
          "  return (int)cudaMemset(at, 0, sizeof(g_stamps));\n}\n")
    return s


def build(nvcc_flags) -> ctypes.CDLL:
    from esvo_tpu_torch.ops import _build
    out = ROOT / "build" / "k4_stamps"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "track_stamped.cu"
    src.write_text(stamped_source())
    lib = out / "track_stamped.so"
    p = subprocess.run([_build._nvcc(), *nvcc_flags, "-o", str(lib),
                        str(src)], capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(p.stdout + p.stderr)
    return ctypes.CDLL(str(lib))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rig", default="rpg", choices=("rpg", "dsec"))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k4_stamps: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from esvo_tpu_torch.ops import _build
    lib = build(_build.NVCC_FLAGS)
    solve = lib.esvo_track_solve
    solve.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 \
        + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    solve.restype = ctypes.c_int
    stamps_fn = lib.esvo_track_stamps
    stamps_fn.argtypes = [ctypes.c_void_p]
    stamps_fn.restype = ctypes.c_int
    clear = lib.esvo_track_stamps_clear
    clear.restype = ctypes.c_int
    card = cs.card_line()
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    rig = cs.make_rig(args.rig, "cuda")
    prob, cam, cfg = cs.track_world(rig, 2000, seed=7)
    for name, batch, n_valid in (("b300_k10", 300, None), ("b32_k10", 32, None),
                                 ("map600_b300_k10", 300, 600)):
        valid = prob.point_valid if n_valid is None else \
            torch.arange(2000, device="cuda") < n_valid
        ins = [a.contiguous() for a in (
            prob.R, prob.t, prob.T_world_ref, prob.points)] + [
            valid.contiguous().view(torch.uint8)] + [a.contiguous() for a in (
                prob.ts_negative, prob.grad_u, prob.grad_v, cam.params.P)] + [
            cam.mask.contiguous().view(torch.uint8)]
        K = cfg.max_iteration
        out = torch.empty(28 + K, device="cuda")
        H, W = prob.ts_negative.shape
        host = (ctypes.c_longlong * 8192)()
        rows = []
        for _ in range(args.iters):
            if clear():
                raise RuntimeError("could not clear the stamps")
            err = solve(*[a.data_ptr() for a in ins], out[:9].data_ptr(),
                        out[9:12].data_ptr(), out[12:28].data_ptr(),
                        out[28:].data_ptr(), 2000, H, W, batch, K,
                        int(cfg.ls_norm == "Huber"), cfg.huber_threshold,
                        cfg.lm_damping,
                        torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err or stamps_fn(ctypes.addressof(host)):
                raise RuntimeError("instrumented K4 launch failed")
            rows.append(list(host))
        full, empty = {ph: [] for ph in PHASES + ALGEBRA}, []
        for st in rows:
            for it in range(K):
                b = 2 + STRIDE * it
                if st[b + 1] == 0 or st[b + 1] < st[b]:  # an empty round
                    empty.append(st[b + 9] - st[b])
                    continue
                for j, ph in enumerate(PHASES):
                    full[ph].append(st[b + j + 1] - st[b + j])
                a = [st[b + 3]] + [st[4096 + 4 * it + k] for k in range(3)] \
                    + [st[b + 4]]
                for j, ph in enumerate(ALGEBRA):
                    full[ph].append(a[j + 1] - a[j])
        med = {ph: statistics.median(v) for ph, v in full.items() if v}
        print(json.dumps(dict(
            k4_stamps=name, rig=args.rig, card=card, clocks_sm=clocks,
            cycles_per_full_round=med,
            full_round_cycles=sum(med[ph] for ph in PHASES if ph in med),
            empty_round_cycles=statistics.median(empty) if empty else None,
            prologue_cycles=statistics.median(r[1] - r[0] for r in rows),
            launch_cycles=statistics.median(
                r[2 + STRIDE * (K - 1) + 9] - r[0] for r in rows))),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
