"""How ``correct`` is decided: the plain reference (benchmark/plainref)
takes the step the program took, from the program's own state before it
and the inputs the benchmark handed both, and the outputs are compared.

The reference can only follow the program step by step: the closed loop
feeds each step's poses and map into the next, and float32 rounding that
the kernels and the twins do in another order grows along a run. So a
check records, for steps drawn from the seed, the program's state before
the step and its outputs after; once the window has closed and the
program is freed, the reference runs each recorded step and every number
below is taken over all of them (the widest reading, or a median):

- ``surface_levels``: the widest gap, in 8-bit levels, between the time
  surfaces the program rendered (and the ones the reference renders from
  the program's state after the step) and the reference's;
- ``pose_m_p90`` / ``pose_rad_p90``: the 90th percentile over the
  ticks checked of the gap between the program's guarded pose and the
  reference's, in translation and in rotation: a fault on one tick in
  five (a mapping tick's) or a bias on every tick moves it, while a
  tracker's LM round that takes the other side of a near-tied accept
  test on one side, which moves one solve by up to millimetres on a tick
  in hundreds, does not (the widest is printed beside them, not
  compared);
- ``estimates_share``: the share of the mapping estimates (block
  matching and the depth LM) whose validity differs or whose inverse
  depths are not close (rtol 2e-4, atol 2e-5: the depth LM's tolerance);
- ``map_share``: the share of the fused and regularized map's occupied
  cells whose occupancy differs or whose inverse depths are not close
  (rtol 1e-3, atol 1e-6).

A cell compares the numbers its workload file gives a limit, each
against that limit; the run is correct when every one lies within it.

The control (the reference in TF32 in the program's place) and the
planted faults that set the limits' upper readings are run by
benchmark/calibrate.py, never by the benchmark's own runs.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

NUMBERS = ("surface_levels", "pose_m_p90", "pose_rad_p90",
           "estimates_share", "map_share")
# the upper readings' faults, planted in the reference in the program's
# place: the name calibrate.py gives, and what it breaks
FAULTS = {"disparity_off_by_one": "block matching's disparity scan picks "
          "the disparity one above its best (the estimates' fault)"}


@contextlib.contextmanager
def fault(name: str | None):
    """With a name of FAULTS, the reference runs with that fault planted
    (for the upper readings); with None, as it is."""
    if name is None:
        yield
        return
    if name != "disparity_off_by_one":
        raise KeyError(f"no fault {name!r}; known: {sorted(FAULTS)}")
    from plainref.mapping import block_matching as bm
    best_disparity = bm.best_disparity

    def off_by_one(ts_left, ts_right, ui, vi, dmin, dmax, *rest):
        best, cost, dark = best_disparity(ts_left, ts_right, ui, vi, dmin,
                                          dmax, *rest)
        return torch.clamp(best + 1, max=dmax - dmin), cost, dark
    bm.best_disparity = off_by_one
    try:
        yield
    finally:
        bm.best_disparity = best_disparity


@contextlib.contextmanager
def precision(mode: str):
    """The reference's float32 matmul precision for a step: "highest"
    (TF32 off, as the configuration states) or "tf32" (the control)."""
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest" if mode == "highest"
                                       else "high")
    torch.backends.cudnn.allow_tf32 = mode != "highest"
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def to_plain(obj, ref):
    """A program dataclass (ResidentState, TimeSurfaceState,
    DepthEstimates, DepthGrid) as the reference's class of that name,
    field by field; tensors are shared, not copied."""
    if isinstance(obj, torch.Tensor) or not dataclasses.is_dataclass(obj):
        return obj
    from plainref.mapping import depth_refinement as dr
    from plainref.mapping import fusion as fu
    from plainref.surface import time_surface as tsf
    classes = {"TimeSurfaceState": tsf.TimeSurfaceState,
               "DepthEstimates": dr.DepthEstimates, "DepthGrid": fu.DepthGrid,
               "ResidentState": ref.step.RollState}
    name = type(obj).__name__
    if name not in classes:
        raise TypeError(f"the reference has no class for the program's "
                        f"{name} (PERF.md, section 3, lists what it maps)")
    return classes[name](**{f.name: to_plain(getattr(obj, f.name), ref)
                            for f in dataclasses.fields(obj)})


def events(d: dict, device):
    """The reference's EventBatch of framed arrays (leading dims kept)."""
    from plainref.surface import time_surface as tsf
    return tsf.EventBatch.from_arrays(d["x"], d["y"], d["t"], d["p"],
                                      d["valid"], device=device)


def pose_gaps(A: np.ndarray, B: np.ndarray) -> tuple[list, list]:
    """Each tick's translation (m) and rotation (rad) gap of (n, 4, 4)
    poses; inf where either is not finite."""
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    A, B = A.reshape(-1, 4, 4), B.reshape(-1, 4, 4)
    if not (np.isfinite(A).all() and np.isfinite(B).all()):
        return [float("inf")] * len(A), [float("inf")] * len(A)
    t = np.linalg.norm(A[:, :3, 3] - B[:, :3, 3], axis=1)
    E = A[:, :3, :3] @ np.swapaxes(B[:, :3, :3], 1, 2)
    w = 0.5 * np.stack([E[:, 2, 1] - E[:, 1, 2], E[:, 0, 2] - E[:, 2, 0],
                        E[:, 1, 0] - E[:, 0, 1]], 1)
    ang = np.arctan2(np.linalg.norm(w, axis=1),
                     (np.trace(E, axis1=1, axis2=2) - 1) / 2)
    return t.tolist(), ang.tolist()


def surface_gap(*pairs) -> float:
    """Widest gap (levels) over pairs of surfaces."""
    gap = 0.0
    for a, b in pairs:
        d = (a.float() - b.float().to(a.device)).abs()
        gap = max(gap, float(d.max()) if torch.isfinite(d).all()
                  else float("inf"))
    return gap


def estimates_share(p, r) -> float:
    """Share of estimate lanes (valid in either) that disagree."""
    vp, vr = p.valid.bool(), r.valid.to(p.valid.device).bool()
    dp = p.inv_depth.float()
    dr = r.inv_depth.float().to(dp.device)
    both = vp & vr
    bad = (vp != vr) | (both & ~torch.isclose(dp, dr, rtol=2e-4, atol=2e-5))
    return float(bad.sum()) / max(int((vp | vr).sum()), 1)


def map_share(p, r) -> float:
    """Share of the map's cells (occupied in either grid) that
    disagree."""
    ip = p.inv_depth.float()
    ir = r.inv_depth.float().to(ip.device)
    op, orr = p.occupied, r.occupied.to(ip.device)
    close = torch.isclose(ip, ir, rtol=1e-3, atol=1e-6, equal_nan=True)
    bad = (op != orr) | (op & orr & ~close)
    return float(bad.sum()) / max(int((op | orr).sum()), 1)


def merge(into: dict, numbers: dict) -> dict:
    """Gather one step's numbers: the widest reading of each, every
    tick's pose gaps (lists)."""
    for k, v in numbers.items():
        if isinstance(v, list):
            into.setdefault(k, []).extend(float(x) for x in v)
            continue
        v = float(v) if np.isfinite(v) else float("inf")
        into[k] = max(into.get(k, 0.0), v)
    return into


def reduce(numbers: dict) -> dict:
    """The numbers compared: the pose gaps' 90th percentile over every
    tick checked as `<name>_p90` (their widest beside it as
    `<name>_widest`, read but not compared), the rest as gathered."""
    out = {}
    for k, v in numbers.items():
        if isinstance(v, list):
            a = np.asarray(v, np.float64)
            nan = float("nan")
            out[k + "_p90"] = float(np.percentile(a, 90)) if a.size else nan
            out[k + "_widest"] = float(a.max()) if a.size else nan
        else:
            out[k] = v
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """correct, and [name, value, limit] for every number the cell
    compares, those its workload file gives a limit (a number with no
    reading fails)."""
    rows = [[k, numbers.get(k, float("nan")), limits[k]] for k in NUMBERS
            if k in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return bool(ok and rows), rows
