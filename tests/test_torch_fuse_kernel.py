"""Kernel K7 (the fusion fold), its dispatch and its plain twin
(mapping/fusion.py).

- ``fuse_frame`` on CPU tensors runs the twin ``fold_slots_plain`` (the
  wrapper is never reached) and equals JAX's ``fuse_frame`` at
  tests/test_torch_fusion.py's cases and tolerances (occupancy on
  >= 99.9% of the cells, every field rtol 1e-5 / atol 1e-7 where both
  grids are occupied, num_fused and num_dropped equal).
- K7's slot placement: each pixel's run of the sorted order
  (``_sort_slots``), as ``run_bounds`` finds it with torch.searchsorted
  (the placement's plain form), holds the same slots in the same order
  as ``_assign_slots``' rank (the twin's (K, H, W) slot plane), and the
  runs' entries past K are its num_dropped: at radius 0 and 1, with
  pixels holding more than K candidates, invalid candidates, NaN
  variances, no valid candidate, no candidate at all and a (0, 0) grid.
- K7's order of operations: a numpy float32 reference of the fold, one
  thread's pixel at a time in csrc/fuse.cu's order (slot by slot through
  the pixel's run of the sorted order, each tiled id read as its
  untiled candidate, one float32 operation at a time, NaN kept by
  minimum and clamp, nu = inf on the Gaussian branch, the age through
  float then truncated), equals ``fuse_frame``'s twin
  (``_assign_slots`` + ``fold_slots_plain``) bit for bit in all 11
  planes, the fuse and drop counts, in Tdist and l2, at fusion radius 0
  and 1, on chip_smoke.fuse_world's grid (a fifth of nu infinite) whose
  candidates hit insert, fuse, replace and occluded cells.
- The dispatch rule (``fold_takes``: float32 grids) and the wrapper's
  checks (dtype, shape, device, whole tiles; a CPU tensor never
  launches).
The kernel itself runs on the card only (tests/test_torch_cuda.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.geometry.se3 import se3_exp
from esvo_tpu.mapping import fusion as jfu
from esvo_tpu_torch.mapping import fusion as tfu
from esvo_tpu_torch.ops import fuse as fuse_op

import chip_smoke
from test_torch_fusion import H, W, _assert_grids, _both, _history, _rigs

f32 = np.float32


@pytest.fixture
def twin_only(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached K7's wrapper")
    monkeypatch.setattr(fuse_op, "fuse_runs", refuse)


@pytest.mark.parametrize("ls_norm,radius,nu_inf", [
    ("Tdist", 0, 0.0), ("Tdist", 1, 0.3), ("l2", 0, 0.0)])
def test_twin_matches_jax(ls_norm, radius, nu_inf, twin_only):
    rj, rt = _rigs()
    est_j, est_t = _both(_history(radius + 7, nu_inf))
    T_fw = np.array(se3_exp(jnp.asarray([0.01, -0.02, 0.005, 0.02, 0.0,
                                         -0.01], jnp.float32)), np.float32)
    kw = dict(ls_norm=ls_norm, fusion_radius=radius,
              max_candidates_per_pixel=4)
    cj, ct = jfu.FusionConfig(**kw), tfu.FusionConfig(**kw)
    cand_j = jfu.propagate_points(est_j, jnp.asarray(T_fw), rj.left, cj)
    cand_t = tfu.propagate_points(est_t, torch.from_numpy(T_fw), rt.left, ct)
    g_j, nf_j, nd_j = jfu.fuse_frame(jfu.empty_grid(H, W), cand_j, rj.left,
                                     cj)
    g_t, nf_t, nd_t = tfu.fuse_frame(tfu.empty_grid(H, W, device="cpu"),
                                     cand_t, rt.left, ct)
    assert int(nd_t) == int(nd_j) and int(nd_t) > 0
    assert int(nf_t) == int(nf_j) and int(nf_t) > 0
    _assert_grids(g_t, g_j)


# --- K7's order of operations, one float32 operation at a time ----------

def _nan_min(a, b):
    if np.isnan(a):
        return a
    if np.isnan(b):
        return b
    return min(a, b)


def _clamp(x, lo):
    return x if (np.isnan(x) or x >= lo) else f32(lo)


def _back_project(A, b, x0, x1, inv):
    z = f32(f32(1.0) / inv)
    r = (f32(f32(z * x0) - b[0]), f32(f32(z * x1) - b[1]), f32(z - b[2]))
    return [f32(f32(f32(A[i, 0] * r[0]) + f32(A[i, 1] * r[1]))
                + f32(A[i, 2] * r[2])) for i in range(3)]


def k7_reference(grid, cand, order, start, end, Kt, K, cam, tdist):
    """The fold of csrc/fuse.cu on numpy float32, pixel by pixel: the
    first min(run, K) entries of the pixel's run [start, end) of the
    sorted order, each tiled id read as its candidate id // Kt; returns
    the 11 planes, num_fused, num_dropped and how often each rule
    fired."""
    A, b = cam[:9].reshape(3, 3), cam[9:]
    Hh, Ww = grid["invD"].shape
    g = {k: v.copy() for k, v in grid.items()}
    c = cand
    fires = dict(insert=0, fuse=0, replace=0, occluded=0)
    fused = dropped = 0
    for q in range(Hh * Ww):
        y, x = divmod(q, Ww)
        gi, gv, gs, gn, gr = (g[k][y, x] for k in ("invD", "var", "s2", "nu",
                                                    "res"))
        ga = int(g["age"][y, x])
        gx0, gx1 = g["x"][y, x]
        gp = list(g["p"][y, x])
        run = int(end[q] - start[q])
        dropped += max(run - K, 0)
        for k in range(min(run, K)):
            i = int(order[start[q] + k]) // Kt
            if not c["invD"][i] > 0:
                continue
            ci, cv, cs, cn, cr = (c[n][i] for n in ("invD", "var", "s2", "nu",
                                                   "res"))
            ca = int(f32(c["age"][i]))
            cx0, cx1 = c["x"][i]
            inv_c = _clamp(ci, f32(1e-12))
            occ = gi > f32(-1e-6)
            if tdist:
                std_g = f32(np.sqrt(_clamp(gv, f32(0))))
                std_c = f32(np.sqrt(_clamp(cv, f32(0))))
                diff = abs(f32(ci - gi))
                compat = diff < f32(2 * std_g) or diff < f32(2 * std_c)
            else:
                e = f32(ci - gi)
                d2 = f32(e * e)
                compat = f32(f32(d2 / _clamp(cv, f32(1e-20)))
                             + f32(d2 / _clamp(gv, f32(1e-20)))) < f32(5.99)
            occluded = f32(gi - f32(f32(2) * f32(np.sqrt(
                _clamp(gv, f32(0)))))) > ci
            if not occ:
                fires["insert"] += 1
                gp = _back_project(A, b, gx0, gx1, inv_c)
                gi, gv, gs, gn, gr, ga = ci, _clamp(cv, f32(1e-6)), cs, cn, \
                    cr, ca
            elif compat:
                fires["fuse"] += 1
                if tdist:
                    nu_u = _nan_min(gn, cn)
                    s_sum = f32(gs + cs)
                    fi = f32(f32(f32(cs * gi) + f32(gs * ci)) / s_sum)
                    e = f32(gi - ci)
                    d2 = f32(e * e)
                    gauss = f32(f32(gs * cs) / s_sum)
                    if np.isfinite(nu_u):
                        fs = f32(f32(f32(nu_u + f32(d2 / s_sum))
                                     / f32(nu_u + f32(1))) * gauss)
                        fn = f32(nu_u + f32(1))
                        fv = f32(f32(fn / _clamp(f32(fn - f32(2)),
                                                 f32(1e-6))) * fs)
                    else:
                        fs, fn, fv = gauss, nu_u, gauss
                    fa = ga + 2
                else:
                    vsum = f32(gv + cv)
                    fi = f32(f32(f32(gv * ci) + f32(cv * gi)) / vsum)
                    fv = f32(f32(gv * cv) / vsum)
                    fs, fn, fa = fv, gn, ga + 1
                gp = _back_project(A, b, gx0, gx1, inv_c)
                gi, gv, gs, gn = fi, _clamp(fv, f32(1e-6)), fs, fn
                gr, ga = _nan_min(gr, cr), fa
                fused += 1
            elif occluded:
                fires["occluded"] += 1
            elif cv < gv and cr < gr:
                fires["replace"] += 1
                gp = _back_project(A, b, cx0, cx1, inv_c)
                gi, gv, gs, gn, gr, ga = ci, cv, cs, cn, cr, ca
                gx0, gx1 = cx0, cx1
        for k, v in (("invD", gi), ("var", gv), ("s2", gs), ("nu", gn),
                     ("res", gr), ("age", ga)):
            g[k][y, x] = v
        g["x"][y, x] = (gx0, gx1)
        g["p"][y, x] = gp
    return g, fused, dropped, fires


@pytest.mark.parametrize("ls_norm, radius", [
    ("Tdist", 0), ("Tdist", 1), ("l2", 0), ("l2", 1)])
def test_kernel_order_equals_twin_bitwise(ls_norm, radius):
    Hh, Ww, K = 64, 48, 8
    grid, cand = chip_smoke.fuse_world(Hh, Ww, 300, seed=radius + 3,
                                       device="cpu")
    cfg = tfu.FusionConfig(ls_norm=ls_norm, fusion_radius=radius,
                           max_candidates_per_pixel=K)
    rig = chip_smoke.make_rig("rpg", "cpu")
    want_grid, want_fused, want_dropped = tfu.fuse_frame(grid, cand,
                                                         rig.left, cfg)
    pix, inb = tfu._splat_pixels(cand, Hh, Ww, radius)
    order, pix_sorted = tfu._sort_slots(pix, cand.valid[:, None] & inb,
                                        cand.variance[:, None], Hh * Ww)
    start, end, _ = tfu.run_bounds(pix_sorted, Hh * Ww, K)
    cam = tfu.camera_words(rig.left.params.P).numpy()
    planes = dict(invD=grid.inv_depth, var=grid.variance, s2=grid.scale2,
                  nu=grid.nu, res=grid.residual, age=grid.age, x=grid.x,
                  p=grid.p_cam)
    cands = dict(invD=cand.inv_depth, var=cand.variance, s2=cand.scale2,
                 nu=cand.nu, res=cand.residual, age=cand.age, x=cand.x)
    got, fused, dropped, fires = k7_reference(
        {k: v.numpy() for k, v in planes.items()},
        {k: v.numpy() for k, v in cands.items()}, order.numpy(),
        start.numpy(), end.numpy(), pix.shape[1], K, cam,
        ls_norm == "Tdist")
    assert min(fires.values()) > 0, fires
    assert fused == int(want_fused) == fires["fuse"]
    assert dropped == int(want_dropped) > 0
    for name, key in (("inv_depth", "invD"), ("variance", "var"),
                      ("scale2", "s2"), ("nu", "nu"), ("residual", "res"),
                      ("age", "age"), ("x", "x"), ("p_cam", "p")):
        np.testing.assert_array_equal(
            getattr(want_grid, name).numpy().view(np.uint8),
            got[key].view(np.uint8), err_msg=name)
    assert np.isinf(got["nu"]).any()


# --- K7's slot placement: runs of the sorted order against the rank ------

def _placement_world(case: str):
    """(cand, H, W, radius) of a placement case: fuse_world's crowded
    candidates (some pixels take more than K), with NaN variances, none
    valid, none at all, or on a (0, 0) grid."""
    H, W = (0, 0) if case == "empty-grid" else (24, 20)
    _, cand = chip_smoke.fuse_world(max(H, 24), max(W, 20), 400, seed=12,
                                    device="cpu")
    radius = 1 if case in ("radius-1", "nan-variance") else 0
    if case == "nan-variance":
        cand.variance[::7] = float("nan")
    if case == "none-valid":
        cand.valid[:] = False
    if case in ("no-candidates", "empty-grid"):
        cand = chip_smoke._tree(cand, lambda a: a[:0])
    return cand, H, W, radius


@pytest.mark.parametrize("case", [
    "radius-0", "radius-1", "nan-variance", "none-valid", "no-candidates",
    "empty-grid"])
def test_run_bounds_place_the_slots_of_assign_slots(case):
    """The first min(run, K) entries of a pixel's run are its slots 0..K-1
    of _assign_slots, and the runs' entries past K its num_dropped."""
    K = 3
    cand, H, W, radius = _placement_world(case)
    hw = H * W
    tiled, pix = tfu._splat(cand, H, W, radius)
    slot, want_dropped = tfu._assign_slots(pix, tiled.valid,
                                           tiled.variance, hw, K)
    # the twin's (K, hw) plane of tiled ids: slot = rank * hw + pixel
    want = torch.full((K * hw + 1,), -1, dtype=torch.int64)
    want[slot] = torch.arange(pix.shape[0])
    want = want[:-1].view(K, hw)
    pix2, inb = tfu._splat_pixels(cand, H, W, radius)
    order, pix_sorted = tfu._sort_slots(pix2, cand.valid[:, None] & inb,
                                        cand.variance[:, None], hw)
    start, end, dropped = tfu.run_bounds(pix_sorted, hw, K)
    got = torch.full((K, hw), -1, dtype=torch.int64)
    for k in range(K):
        has = end - start > k
        got[k, has] = order[start[has] + k]
    assert torch.equal(got, want)
    assert int(dropped) == int(want_dropped)
    if case in ("radius-0", "radius-1", "nan-variance"):
        assert int(dropped) > 0 and bool((want >= 0).any())
    else:
        assert int(dropped) == 0 and not bool((want >= 0).any())
    # every run entry is a tile of a valid candidate on that run's pixel
    n = int((pix_sorted < hw).sum())
    assert torch.equal(pix2.reshape(-1)[order[:n]], pix_sorted[:n])
    assert bool((cand.valid[:, None] & inb).reshape(-1)[order[:n]].all())


@pytest.mark.parametrize("case", [
    "radius-0", "radius-1", "nan-variance", "none-valid", "no-candidates",
    "empty-grid"])
def test_byte_bound_reads_each_taken_candidate_once(case):
    """chip_smoke.k7_bytes, K7's byte bound, counts what the twin's slot
    plane takes: each pixel's 22 grid words, the sorted ids inside the
    grid, an order entry a kept slot and 8 words a distinct kept
    candidate (its tiles share them), the camera and the two counts."""
    K = 3
    cand, H, W, radius = _placement_world(case)
    hw = H * W
    tiled, pix = tfu._splat(cand, H, W, radius)
    slot, _ = tfu._assign_slots(pix, tiled.valid, tiled.variance, hw, K)
    kept = torch.nonzero(slot < hw * K).reshape(-1)
    pix2, inb = tfu._splat_pixels(cand, H, W, radius)
    kt = pix2.shape[1]
    order, pix_sorted = tfu._sort_slots(pix2, cand.valid[:, None] & inb,
                                        cand.variance[:, None], hw)
    start, _, _ = tfu.run_bounds(pix_sorted, hw, K)
    distinct = len({int(i) // kt for i in kept})
    want = (hw * 22 * 4 + int((pix_sorted < hw).sum()) * 8
            + kept.numel() * 8 + distinct * 32 + 12 * 4 + 2 * 8)
    assert chip_smoke.k7_bytes(order, pix_sorted, start, hw, K, kt) == want
    if case in ("radius-0", "radius-1", "nan-variance"):
        assert 0 < distinct < kept.numel()


# --- the dispatch rule and the wrapper's checks ---------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_grids_take_the_twin(dtype, twin_only):
    grid, cand = chip_smoke.fuse_world(12, 16, 60, seed=1, device="cpu")
    grid = grid.replace(**{k: getattr(grid, k).to(dtype) for k in (
        "inv_depth", "variance", "scale2", "nu", "residual", "x", "p_cam")})
    assert tfu.fold_takes(grid) == (dtype == torch.float32)
    rig = chip_smoke.make_rig("rpg", "cpu")
    out, nf, nd = tfu.fuse_frame(grid, cand, rig.left, tfu.FusionConfig())
    assert out.inv_depth.dtype == dtype and int(nf) >= 0


def _wrapper_args(H=6, W=7, M=5, Kt=4):
    grid = dict(invD=torch.zeros(H, W), var=torch.ones(H, W),
                s2=torch.ones(H, W), nu=torch.ones(H, W),
                res=torch.zeros(H, W),
                age=torch.zeros(H, W, dtype=torch.int32),
                x=torch.zeros(H, W, 2), p=torch.zeros(H, W, 3))
    cand = dict(invD=torch.zeros(M), var=torch.ones(M), s2=torch.ones(M),
                nu=torch.ones(M), res=torch.zeros(M),
                age=torch.zeros(M, dtype=torch.int32), x=torch.zeros(M, 2))
    order = torch.arange(M * Kt)
    return grid, cand, order, torch.full((M * Kt,), H * W), torch.zeros(12)


@pytest.mark.parametrize("where, name, bad, exc", [
    ("grid", "var", torch.ones(6, 7, dtype=torch.float64), TypeError),
    ("grid", "age", torch.zeros(6, 7), TypeError),
    ("grid", "p", torch.zeros(6, 7, 2), ValueError),
    ("cand", "x", torch.zeros(5, 3), ValueError),
    ("cand", "nu", torch.ones(5, device="meta"), ValueError),
    ("order", None, torch.arange(20, dtype=torch.int32), TypeError),
    ("cam", None, torch.zeros(12, dtype=torch.float64), TypeError),
    ("runs", None, torch.arange(18), ValueError),
], ids=["var-f64", "age-float", "p-shape", "cand-x-shape", "device",
        "order-int32", "cam-f64", "order-part-tiles"])
def test_wrapper_checks_raise(where, name, bad, exc):
    grid, cand, order, pix_sorted, cam = _wrapper_args()
    fuse_op.check_inputs(grid, cand, order, pix_sorted, cam)
    if where == "grid":
        grid[name] = bad
    elif where == "cand":
        cand[name] = bad
    elif where == "order":
        order = bad
    elif where == "runs":
        order, pix_sorted = bad, torch.full((18,), 42)
    else:
        cam = bad
    with pytest.raises(exc):
        fuse_op.check_inputs(grid, cand, order, pix_sorted, cam)


def test_wrapper_refuses_cpu_tensors():
    grid, cand, order, pix_sorted, cam = _wrapper_args()
    before = fuse_op.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        fuse_op.fuse_runs(grid, cand, order, pix_sorted, cam, K=8,
                          tdist=True)
    assert fuse_op.KERNEL.launches == before
