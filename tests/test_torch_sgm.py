"""The port's SGM bootstrap (mapping/initialization.py) against the JAX
package's.

- On integer 8-bit surfaces every cost, path sum and penalty is an
  integer below 2^24, exact in float32: disparity and validity must be
  equal bit for bit (cost volume, 4-path aggregation, winner-take-all
  with first-index ties, uniqueness, parabola refinement).
- On rendered, rectified surfaces (bilinear remap: non-integer costs,
  sums in another order): the same best disparity on >= 99.5% of the
  pixels, and sgm_depth_points' inverse depth to rtol 1e-6 where both
  are valid at the same best disparity.
- event_edge_mask exact.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.geometry import camera as jcam
from esvo_tpu.io import synthetic as jsyn
from esvo_tpu.io.events import frame_events
from esvo_tpu.mapping import initialization as jinit
from esvo_tpu.surface import time_surface as jts
from esvo_tpu_torch import convert
from esvo_tpu_torch.mapping import initialization as tinit

W, H = 120, 90
f32 = np.float32


def _cfgs(**kw):
    return jinit.SGMConfig(**kw), tinit.SGMConfig(**kw)


def _integer_pair(rng, disp_top, disp_bottom):
    """An 8-bit textured pair whose right image is the left one shifted
    by disp_top pixels in the upper half and disp_bottom in the lower."""
    base = rng.integers(0, 256, size=(H, W + 64)).astype(np.float64)
    base = np.apply_along_axis(lambda r: np.convolve(r, np.ones(3) / 3,
                                                     "same"), 1, base)
    base = np.round(base)
    left = base[:, 32:32 + W]
    right = np.empty_like(left)
    right[:H // 2] = base[:H // 2, 32 + disp_top:32 + disp_top + W]
    right[H // 2:] = base[H // 2:, 32 + disp_bottom:32 + disp_bottom + W]
    return left.astype(f32), right.astype(f32)


@pytest.mark.parametrize("num_disparities, disps, seed",
                         [(48, (7, 7), 0), (32, (4, 12), 1), (48, (3, 30), 2)])
def test_sgm_exact_on_integer_surfaces(num_disparities, disps, seed):
    left, right = _integer_pair(np.random.default_rng(seed), *disps)
    cj, ct = _cfgs(num_disparities=num_disparities)
    np.testing.assert_array_equal(
        tinit.cost_volume(torch.from_numpy(left), torch.from_numpy(right),
                          ct).numpy(),
        np.asarray(jinit.cost_volume(jnp.asarray(left), jnp.asarray(right),
                                     cj)))
    dj, vj = jinit.semi_global_matching(jnp.asarray(left),
                                        jnp.asarray(right), cj)
    dt, vt = tinit.semi_global_matching(torch.from_numpy(left),
                                        torch.from_numpy(right), ct)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    v = vt.numpy()
    assert v.mean() > 0.3
    inner = v[10:H // 2 - 8, 40:-10]
    top = dt.numpy()[10:H // 2 - 8, 40:-10][inner]
    assert np.median(np.abs(top - disps[0])) < 0.5


def test_box_sum_is_a_block_sum():
    img = np.random.default_rng(3).integers(0, 256, (2, 17, 23)).astype(f32)
    got = tinit._box_sum(torch.from_numpy(img), 5).numpy()
    np.testing.assert_array_equal(got, np.asarray(jinit._box_sum(
        jnp.asarray(img), 5)))
    pad = np.pad(img, ((0, 0), (2, 2), (2, 2)))
    assert got[1, 8, 9] == pad[1, 8:13, 9:14].sum()


def test_event_edge_mask():
    xs = np.array([[3.2, 4.7], [10.0, 10.0], [119.9, 89.2], [-0.5, 3.0],
                   [50.5, 95.0]], f32)
    valid = np.array([True, True, True, True, False])
    for radius in (0, 1, 2):
        mj = jinit.event_edge_mask(jnp.asarray(xs), jnp.asarray(valid), H, W,
                                   radius=radius)
        mt = tinit.event_edge_mask(torch.from_numpy(xs),
                                   torch.from_numpy(valid), H, W,
                                   radius=radius)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert mt.numpy()[4, 3] and mt.numpy()[89, 119]


@pytest.fixture(scope="module")
def rendered():
    """Rectified backward surfaces of a synthetic stereo scene (JAX's
    render, non-integer after the remap), the rig, and one tick's
    events."""
    fx, b = 75.0, 0.1
    cx, cy = W / 2 - 0.5, H / 2 - 0.5
    K = np.array([[fx, 0, cx], [0, fx, cy], [0, 0, 1]])
    cams, raw = [], []
    for tx in (0.0, -fx * b):
        P = np.array([[fx, 0, cx + 0.37, tx], [0, fx, cy + 0.21, 0],
                      [0, 0, 1, 0]])
        cams.append(jcam.make_camera(jcam.PinholeParams(
            K=jnp.asarray(K, jnp.float32), D=jnp.zeros(4, jnp.float32),
            R=jnp.eye(3, dtype=jnp.float32), P=jnp.asarray(P, jnp.float32),
            width=W, height=H)))
        raw.append(np.concatenate([K, [[tx], [0], [0]]], axis=1))
    T = np.eye(4, dtype=f32)
    T[0, 3] = -b
    rig = jcam.StereoRig(left=cams[0], right=cams[1],
                         T_right_left=jnp.asarray(T),
                         baseline=jnp.asarray(b, jnp.float32))
    rng = np.random.default_rng(11)
    scene = jsyn.make_scene(rng, num_points=2000, duration=0.06, steps=7,
                            motion_scale=0.6)
    ev_l, ev_r = jsyn.simulate_stereo_events(scene, *raw, W, H,
                                             pixel_threshold=0.75, rng=rng)
    ticks = np.arange(1, 6) * 0.01
    fl, fr = frame_events(ev_l, ticks, 1500), frame_events(ev_r, ticks, 1500)
    cfg = jts.TimeSurfaceConfig()
    st = [jts.init_state(H, W), jts.init_state(H, W)]
    for k in range(len(ticks)):
        for i, f in enumerate((fl, fr)):
            st[i] = jts.insert_events(st[i], jts.EventBatch.from_arrays(
                *[f[key][k] for key in ("x", "y", "t", "p", "valid")]))
    surf = [np.asarray(jts.render_backward(s, jnp.float32(ticks[-1]), c, cfg),
                       f32) for s, c in zip(st, cams)]
    assert (surf[0] != np.round(surf[0])).mean() > 0.05
    lut = np.asarray(rig.left.lut)
    k = len(ticks) - 1
    ok = fl["valid"][k]
    x_rect = lut[fl["y"][k][ok], fl["x"][k][ok]][:300].astype(f32)
    return rig, surf, x_rect


def test_sgm_on_rendered_surfaces(rendered):
    rig, (left, right), x_rect = rendered
    cj, ct = _cfgs()
    dj, vj = (np.asarray(a) for a in jinit.semi_global_matching(
        jnp.asarray(left), jnp.asarray(right), cj))
    dt, vt = (a.numpy() for a in tinit.semi_global_matching(
        torch.from_numpy(left), torch.from_numpy(right), ct))
    best_j, best_t = np.round(dj), np.round(dt)
    assert (best_t == best_j).mean() >= 0.995
    assert (vt == vj).mean() >= 0.995
    same = best_t == best_j
    np.testing.assert_allclose(dt[same], dj[same], rtol=1e-5, atol=1e-4)

    n = len(x_rect)
    valid = np.ones(n, bool)
    valid[::7] = False
    T_wf = np.eye(4, dtype=f32)
    T_wf[:3, 3] = [0.1, -0.2, 0.3]
    est_j = jinit.sgm_depth_points(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(x_rect),
        jnp.asarray(valid), jnp.asarray(T_wf), rig, cj, 0.2, 2.0, init_age=1)
    rt = convert.rig_from_numpy(convert.rig_to_numpy(rig), device="cpu")
    est_t = tinit.sgm_depth_points(
        torch.from_numpy(left), torch.from_numpy(right),
        torch.from_numpy(x_rect), torch.from_numpy(valid),
        torch.from_numpy(T_wf), rt, ct, 0.2, 2.0, init_age=1)
    xi = np.floor(x_rect).astype(int)
    at_same = same[np.clip(xi[:, 1], 0, H - 1), np.clip(xi[:, 0], 0, W - 1)]
    vj_e, vt_e = np.asarray(est_j.valid), est_t.valid.numpy()
    np.testing.assert_array_equal(vt_e[at_same], vj_e[at_same])
    both = vj_e & vt_e & at_same
    assert both.sum() > 0.2 * n
    for name in ("inv_depth", "p_cam", "x", "variance", "scale2", "nu",
                 "residual", "age", "T_world_cam"):
        np.testing.assert_allclose(getattr(est_t, name).numpy()[both],
                                   np.asarray(getattr(est_j, name))[both],
                                   rtol=1e-6, atol=1e-7, err_msg=name)
