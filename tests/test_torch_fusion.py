"""Parity of the port's propagation, fusion, cleaning and regularization
with the JAX package, on a history with deliberate ties in (pixel,
variance): the slot order then rests on the stable tie-break by original
index. Occupancy must agree on at least 99.9% of the cells, and every
field to rtol 1e-5 where both grids are occupied.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.geometry.camera import make_ideal_rig
from esvo_tpu.geometry.se3 import se3_exp
from esvo_tpu.mapping import depth_refinement as jdr
from esvo_tpu.mapping import fusion as jfu
from esvo_tpu.mapping import regularization as jreg
from esvo_tpu_torch import convert
from esvo_tpu_torch.mapping import fusion as tfu
from esvo_tpu_torch.mapping import regularization as treg

W, H, FX = 64, 48, 50.0
N = 400


def _rigs():
    rj = make_ideal_rig(W, H, FX, FX, W / 2 - 0.5, H / 2 - 0.5, 0.1,
                        dtype=jnp.float32)
    return rj, convert.rig_from_numpy(convert.rig_to_numpy(rj), device="cpu")


def _history(seed, nu_inf_share=0.0):
    """N estimates; a third of them duplicate another one's pixel and
    variance exactly (ties in the sort keys)."""
    rng = np.random.default_rng(seed)
    rj, _ = _rigs()
    x = np.stack([rng.uniform(0, W, N), rng.uniform(0, H, N)], 1)
    invd = rng.uniform(0.3, 1.5, N)
    var = rng.choice([1e-4, 2e-4, 5e-4], N)          # few distinct values
    dup = rng.choice(N, N // 3, replace=False)
    src = rng.choice(N, N // 3)
    x[dup] = x[src]
    var[dup] = var[src]
    invd[dup] = invd[src] * rng.uniform(0.97, 1.03, N // 3)
    nu = np.where(rng.random(N) < nu_inf_share, np.inf, 2.19)
    scale2 = var * (1 - 2 / nu)          # nu = inf: scale2 = var
    xi = rng.normal(0, 4e-3, (N, 6))
    T = np.asarray(se3_exp(jnp.asarray(xi, jnp.float32)), np.float32)
    P = np.asarray(rj.left.params.P, np.float64)
    p_cam = np.stack([np.linalg.solve(P[:, :3], (1 / invd[i])
                                      * np.array([x[i, 0], x[i, 1], 1.0])
                                      - P[:, 3]) for i in range(N)])
    f = np.float32
    return dict(x=x.astype(f), inv_depth=invd.astype(f),
                variance=var.astype(f), scale2=scale2.astype(f),
                nu=nu.astype(f), residual=rng.uniform(0, 50, N).astype(f),
                age=rng.integers(0, 3, N).astype(np.int32),
                p_cam=p_cam.astype(f), T_world_cam=T,
                valid=rng.random(N) > 0.1)


def _both(d):
    est_j = jdr.DepthEstimates(**{k: jnp.asarray(v) for k, v in d.items()})
    est_t = convert.state_from_numpy({"history": d}, device="cpu")["history"]
    return est_j, est_t


def _assert_grids(gt, gj):
    occ_t, occ_j = gt.occupied.numpy(), np.asarray(gj.occupied)
    assert (occ_t == occ_j).mean() >= 0.999
    both = occ_t & occ_j
    assert both.sum() > 50
    for name in ("inv_depth", "variance", "scale2", "nu", "residual",
                 "age", "x", "p_cam"):
        np.testing.assert_allclose(getattr(gt, name).numpy()[both],
                                   np.asarray(getattr(gj, name))[both],
                                   rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("ls_norm,radius,nu_inf", [
    ("Tdist", 0, 0.0), ("Tdist", 1, 0.3), ("l2", 0, 0.0)])
def test_fuse_clean_regularize(ls_norm, radius, nu_inf):
    rj, rt = _rigs()
    est_j, est_t = _both(_history(radius + 7, nu_inf))
    T_fw = np.array(se3_exp(jnp.asarray([0.01, -0.02, 0.005, 0.02, 0.0,
                                         -0.01], jnp.float32)), np.float32)
    cj = jfu.FusionConfig(ls_norm=ls_norm, fusion_radius=radius,
                          max_candidates_per_pixel=4)
    ct = tfu.FusionConfig(ls_norm=ls_norm, fusion_radius=radius,
                          max_candidates_per_pixel=4)
    cand_j = jfu.propagate_points(est_j, jnp.asarray(T_fw), rj.left, cj)
    cand_t = tfu.propagate_points(est_t, torch.from_numpy(T_fw), rt.left, ct)
    np.testing.assert_array_equal(cand_t.valid.numpy(),
                                  np.asarray(cand_j.valid))
    g_j, nf_j, nd_j = jfu.fuse_frame(jfu.empty_grid(H, W), cand_j, rj.left,
                                     cj)
    g_t, nf_t, nd_t = tfu.fuse_frame(tfu.empty_grid(H, W, device="cpu"),
                                     cand_t, rt.left, ct)
    assert int(nd_t) == int(nd_j) and int(nd_t) > 0     # cap K exercised
    assert int(nf_t) == int(nf_j) and int(nf_t) > 0
    _assert_grids(g_t, g_j)

    args = (1e-3, 1, 2.0, 0.2)
    c_j = jfu.clean_grid(g_j, *args)
    c_t = tfu.clean_grid(g_t, *args)
    _assert_grids(c_t, c_j)

    rcfg = dict(ls_norm=ls_norm, radius=2, min_neighbours=2,
                min_close_neighbours=1)
    r_j = jreg.regularize(c_j, jreg.RegularizationConfig(**rcfg))
    r_t = treg.regularize(c_t, treg.RegularizationConfig(**rcfg))
    _assert_grids(r_t, r_j)

    T_wf = np.linalg.inv(T_fw).astype(np.float32)
    p_j, o_j = jfu.grid_points_world(r_j, jnp.asarray(T_wf))
    p_t, o_t = tfu.grid_points_world(r_t, torch.from_numpy(T_wf))
    both = o_t.numpy() & np.asarray(o_j)
    np.testing.assert_allclose(p_t.numpy()[both], np.asarray(p_j)[both],
                               rtol=1e-5, atol=1e-6)


def test_naive_fuse_frame():
    rj, rt = _rigs()
    est_j, est_t = _both(_history(3))
    cj = jfu.FusionConfig(max_candidates_per_pixel=3)
    ct = tfu.FusionConfig(max_candidates_per_pixel=3)
    eye = np.eye(4, dtype=np.float32)
    g_j = jfu.naive_fuse_frame(
        jfu.empty_grid(H, W),
        jfu.propagate_points(est_j, jnp.asarray(eye), rj.left, cj),
        rj.left, cj)
    g_t = tfu.naive_fuse_frame(
        tfu.empty_grid(H, W, device="cpu"),
        tfu.propagate_points(est_t, torch.from_numpy(eye), rt.left, ct),
        rt.left, ct)
    _assert_grids(g_t, g_j)


def test_slot_ties_break_by_index():
    """Equal (pixel, value) keys keep their original order, invalid keys
    go last, and overflow past K is dropped and counted."""
    pix = torch.tensor([5, 3, 5, 5, 3, 7, 5])
    val = torch.tensor([1.0, 2.0, 1.0, 0.5, 2.0, 1.0, 1.0])
    valid = torch.tensor([True, True, True, True, True, False, True])
    slot, dropped = tfu._assign_slots(pix, valid, val, 10, 3)
    # pixel 5: order 3 (0.5), then 0, 2 (ties by index), 6 dropped
    assert slot.tolist() == [15, 3, 25, 5, 13, 30, 30]
    assert int(dropped) == 1
