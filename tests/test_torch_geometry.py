"""Parity of the port's geometry (se3, camera, remap_bilinear,
valid_pixel_mask) with the JAX package, on the CPU.

Inputs come from a seeded numpy generator and go to JAX as explicit f32
(conftest turns on jax_enable_x64) and to the port as torch tensors.
Pixel coordinates (rectification LUT, inverse map, projections) agree
to atol 1e-5 px, in f64 and in f32.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.geometry import camera as jcam
from esvo_tpu.geometry import se3 as jse3
from esvo_tpu_torch.geometry import camera as tcam
from esvo_tpu_torch.geometry import se3 as tse3

W, H = 64, 48


def _j(a, dt=jnp.float32):
    return jnp.asarray(a, dt)


def _t(a, dt=torch.float32):
    return torch.tensor(np.array(a)).to(dt)


def _poses(rng, n):
    xi = rng.normal(0, 0.4, (n, 6))
    return np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float64)))


@pytest.mark.parametrize("fn", ["cayley_to_rot", "so3_exp", "so3_hat"])
def test_vec3_to_matrix(fn):
    rng = np.random.default_rng(0)
    v = rng.normal(0, 0.7, (32, 3)).astype(np.float32)
    want = np.asarray(getattr(jse3, fn)(_j(v)))
    got = getattr(tse3, fn)(_t(v)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("fn", ["rot_to_cayley", "rot_to_quat", "so3_log"])
def test_matrix_to_vec(fn):
    rng = np.random.default_rng(1)
    R = _poses(rng, 32)[:, :3, :3].astype(np.float32)
    want = np.asarray(getattr(jse3, fn)(_j(R)))
    got = getattr(tse3, fn)(_t(R)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_se3_exp_log_inverse_rows():
    rng = np.random.default_rng(2)
    xi = rng.normal(0, 0.5, (32, 6)).astype(np.float32)
    T = np.asarray(jse3.se3_exp(_j(xi)))
    np.testing.assert_allclose(tse3.se3_exp(_t(xi)).numpy(), T, atol=2e-6)
    np.testing.assert_allclose(tse3.se3_log(_t(T)).numpy(),
                               np.asarray(jse3.se3_log(_j(T))), atol=2e-5)
    np.testing.assert_allclose(tse3.se3_inverse(_t(T)).numpy(),
                               np.asarray(jse3.se3_inverse(_j(T))),
                               atol=2e-6)
    rows_j = jse3.rows_from_matrices(_j(T))
    rows_t = tse3.rows_from_matrices(_t(T))
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    p = rng.normal(0, 1, (3, 32)).astype(np.float32)
    want = jse3.rows_apply(rows_j, *[_j(c) for c in p])
    got = tse3.rows_apply(rows_t, *[_t(c) for c in p])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_quat_slerp_and_pose_table():
    rng = np.random.default_rng(3)
    S = 12
    times = np.sort(rng.uniform(0, 1, S)).astype(np.float32)
    poses = _poses(rng, S).astype(np.float32)
    q = rng.uniform(-0.1, 1.1, 40).astype(np.float32)   # incl. clamping
    want = np.asarray(jse3.interpolate_pose_table(_j(times), _j(poses),
                                                  _j(q)))
    got = tse3.interpolate_pose_table(_t(times), _t(poses), _t(q)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    q0 = np.asarray(jse3.rot_to_quat(_j(poses[:6, :3, :3])))
    q1 = np.asarray(jse3.rot_to_quat(_j(poses[6:, :3, :3])))
    a = rng.uniform(0, 1, 6).astype(np.float32)
    np.testing.assert_allclose(
        tse3.slerp(_t(q0), _t(q1), _t(a)).numpy(),
        np.asarray(jse3.slerp(_j(q0), _j(q1), _j(a))), atol=2e-6)
    np.testing.assert_allclose(tse3.quat_to_rot(_t(q0)).numpy(),
                               np.asarray(jse3.quat_to_rot(_j(q0))),
                               atol=2e-6)


def _params(module, model, dt, tensor):
    """A distorted, rectified camera (non-identity R, non-zero D)."""
    th = 0.03
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]]) @ np.array(
        [[1, 0, 0], [0, np.cos(0.02), -np.sin(0.02)],
         [0, np.sin(0.02), np.cos(0.02)]])
    D = ([-0.28, 0.07, 1.5e-3, -8e-4] if model == "plumb_bob"
         else [0.05, -0.01, 0.002, -0.0005])
    K = [[52.0, 0, W / 2 - 0.3], [0, 51.0, H / 2 + 0.4], [0, 0, 1.0]]
    P = [[47.0, 0, W / 2, -4.7], [0, 47.0, H / 2, 0], [0, 0, 1, 0]]
    return module.PinholeParams(
        K=tensor(K, dt), D=tensor(D, dt), R=tensor(R, dt), P=tensor(P, dt),
        width=W, height=H, model=model)


@pytest.mark.parametrize("model", ["plumb_bob", "equidistant"])
def test_rectification_maps_f64(model):
    pj = _params(jcam, model, jnp.float64, _j)
    pt = _params(tcam, model, torch.float64, _t)
    for fn in ("rectification_lut", "inverse_rectification_map"):
        np.testing.assert_allclose(getattr(tcam, fn)(pt).numpy(),
                                   np.asarray(getattr(jcam, fn)(pj)),
                                   atol=1e-5)


def test_camera_f32_distorted():
    """make_camera on a plumb_bob camera with distortion and a rotated
    rectification: LUT, inverse map, valid mask."""
    cj = jcam.make_camera(_params(jcam, "plumb_bob", jnp.float32, _j))
    ct = tcam.make_camera(_params(tcam, "plumb_bob", torch.float32, _t))
    np.testing.assert_allclose(ct.lut.numpy(), np.asarray(cj.lut), atol=1e-5)
    np.testing.assert_allclose(ct.inv_map.numpy(), np.asarray(cj.inv_map),
                               atol=1e-5)
    agree = (ct.mask.numpy() == np.asarray(cj.mask)).mean()
    assert agree >= 0.999
    assert 0.3 < ct.mask.numpy().mean() < 1.0     # a real border exists


def test_remap_bilinear_and_mask_same_map():
    """remap_bilinear and valid_pixel_mask on the very same f32 map."""
    rng = np.random.default_rng(5)
    pj = _params(jcam, "plumb_bob", jnp.float32, _j)
    inv = np.asarray(jcam.inverse_rectification_map(pj))
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    want = np.asarray(jcam.remap_bilinear(_j(img), _j(inv)))
    got = tcam.remap_bilinear(_t(img), _t(inv)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * 255)
    pt = _params(tcam, "plumb_bob", torch.float32, _t)
    np.testing.assert_array_equal(
        tcam.valid_pixel_mask(pt, _t(inv)).numpy(),
        np.asarray(jcam.valid_pixel_mask(pj, _j(inv))))
    # a partial map (..., 2) with a non-zero fill takes the gather path
    pts = rng.uniform(-3, W + 3, (50, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tcam.remap_bilinear(_t(img), _t(pts), fill=7.0).numpy(),
        np.asarray(jcam.remap_bilinear(_j(img), _j(pts), fill=7.0)),
        atol=1e-5 * 255)


def test_projection_roundtrip_and_ideal_rig():
    rng = np.random.default_rng(6)
    rj = jcam.make_ideal_rig(W, H, 40.0, 41.0, W / 2, H / 2, 0.12,
                             dtype=jnp.float32)
    rt = tcam.make_ideal_rig(W, H, 40.0, 41.0, W / 2, H / 2, 0.12,
                             device="cpu")
    for a, b in ((rt.left.params.P, rj.left.params.P),
                 (rt.right.params.P, rj.right.params.P),
                 (rt.T_right_left, rj.T_right_left),
                 (rt.left.lut, rj.left.lut), (rt.left.mask, rj.left.mask)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = rng.uniform(0, W, (40, 2)).astype(np.float32)
    d = rng.uniform(0.2, 2.0, 40).astype(np.float32)
    P = np.asarray(rj.left.params.P)
    pw_j = jcam.cam_to_world(_j(P), _j(x), _j(d))
    pw_t = tcam.cam_to_world(_t(P), _t(x), _t(d))
    np.testing.assert_allclose(pw_t.numpy(), np.asarray(pw_j), atol=1e-5)
    np.testing.assert_allclose(tcam.world_to_cam(_t(P), pw_t).numpy(), x,
                               atol=1e-5)
    np.testing.assert_allclose(tcam.inv3(_t(P[:, :3])).numpy(),
                               np.asarray(jcam.inv3(_j(P[:, :3]))),
                               atol=1e-7)


def test_load_rig_from_yaml(tmp_path):
    """load_rig parses an ESVO calibration directory like the JAX one."""
    def write(name, P, extra=""):
        (tmp_path / name).write_text(
            f"image_width: {W}\nimage_height: {H}\n"
            "camera_matrix: {rows: 3, cols: 3, data: "
            "[50.0, 0, 31.5, 0, 50.5, 23.5, 0, 0, 1]}\n"
            "distortion_model: plumb_bob\n"
            "distortion_coefficients: {rows: 1, cols: 4, data: "
            "[-0.2, 0.05, 0.001, -0.001]}\n"
            "rectification_matrix: {rows: 3, cols: 3, data: "
            "[0.9998, 0, 0.02, 0, 1, 0, -0.02, 0, 0.9998]}\n"
            f"projection_matrix: {{rows: 3, cols: 4, data: {P}}}\n" + extra)
    write("left.yaml", "[48, 0, 32, 0, 0, 48, 24, 0, 0, 0, 1, 0]",
          "T_right_left: {rows: 3, cols: 4, data: "
          "[1, 0, 0, -0.1, 0, 1, 0, 0, 0, 0, 1, 0]}\n")
    write("right.yaml", "[48, 0, 32, -4.8, 0, 48, 24, 0, 0, 0, 1, 0]")
    rj = jcam.load_rig(str(tmp_path), dtype=jnp.float32)
    rt = tcam.load_rig(str(tmp_path), device="cpu")
    assert abs(float(rt.baseline) - float(rj.baseline)) < 1e-7
    np.testing.assert_array_equal(rt.T_right_left.numpy(),
                                  np.asarray(rj.T_right_left))
    np.testing.assert_allclose(rt.right.lut.numpy(),
                               np.asarray(rj.right.lut), atol=1e-5)
