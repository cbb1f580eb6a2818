"""Parity of the port's time-surface engine with the JAX package.

insert_events is exact. A rendered surface is held level by level: at
least 99.9% of pixels equal and the rest within one 8-bit level (the two
libraries' exp may differ by an ulp and flip a rounding tie). The filters
agree to atol 1e-5.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.geometry import camera as jcam
from esvo_tpu.surface import time_surface as jts
from esvo_tpu_torch import convert
from esvo_tpu_torch.surface import time_surface as tts

W, H = 64, 48


def _events(rng, n, t0=0.0, t1=0.1):
    x = rng.integers(-2, W + 2, n).astype(np.int32)    # a few off-sensor
    y = rng.integers(-2, H + 2, n).astype(np.int32)
    t = np.sort(rng.uniform(t0, t1, n)).astype(np.float32)
    p = rng.random(n) > 0.5
    valid = rng.random(n) > 0.05
    return x, y, t, p, valid


def _distorted_rig_jax():
    th = 0.02
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]])
    K = np.array([[50.0, 0, W / 2 - 0.4], [0, 50.5, H / 2 + 0.3], [0, 0, 1]])
    cams = []
    for tx in (0.0, -4.5):
        P = np.array([[46.0, 0, W / 2, tx], [0, 46.0, H / 2, 0], [0, 0, 1, 0]])
        params = jcam.PinholeParams(
            K=jnp.asarray(K, jnp.float32),
            D=jnp.asarray([-0.25, 0.06, 1e-3, -6e-4], jnp.float32),
            R=jnp.asarray(R, jnp.float32), P=jnp.asarray(P, jnp.float32),
            width=W, height=H, model="plumb_bob")
        cams.append(jcam.make_camera(params))
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -0.09
    return jcam.StereoRig(left=cams[0], right=cams[1],
                          T_right_left=jnp.asarray(T),
                          baseline=jnp.asarray(0.09, jnp.float32))


def _insert_both(rng, n_frames=3, n=400):
    sj = jts.init_state(H, W)
    st = tts.init_state(H, W, device="cpu")
    for k in range(n_frames):
        x, y, t, p, v = _events(rng, n, 0.05 * k, 0.05 * (k + 1))
        sj = jts.insert_events(sj, jts.EventBatch.from_arrays(x, y, t, p, v))
        st = tts.insert_events(st, tts.EventBatch.from_arrays(
            x, y, t, p, v, device="cpu"))
    return sj, st


def test_insert_events_exact():
    sj, st = _insert_both(np.random.default_rng(0))
    np.testing.assert_array_equal(st.last_t_pos.numpy(),
                                  np.asarray(sj.last_t_pos))
    np.testing.assert_array_equal(st.last_t_neg.numpy(),
                                  np.asarray(sj.last_t_neg))
    assert np.isfinite(st.last_t_pos.numpy()).all()   # NO_EVENT is finite


def _assert_levels(got, want):
    diff = np.abs(got - want)
    assert (diff == 0).mean() >= 0.999, (diff > 0).sum()
    assert diff.max() <= 1.0


@pytest.mark.parametrize("ignore_polarity", [True, False])
def test_render_backward_distorted_rig(ignore_polarity):
    rng = np.random.default_rng(1)
    sj, st = _insert_both(rng)
    rj = _distorted_rig_jax()
    rt = convert.rig_from_numpy(convert.rig_to_numpy(rj), device="cpu")
    cj = jts.TimeSurfaceConfig(ignore_polarity=ignore_polarity)
    ct = tts.TimeSurfaceConfig(ignore_polarity=ignore_polarity)
    for cam_j, cam_t in ((rj.left, rt.left), (rj.right, rt.right)):
        want = np.asarray(jts.render_backward(sj, jnp.float32(0.16), cam_j,
                                              cj))
        got = tts.render_backward(st, torch.tensor(0.16), cam_t, ct).numpy()
        # the 8-bit levels before the remap, then the rectified image: a
        # flipped level moves the remapped pixels around it by < 1 level
        lvl_j = np.asarray(jts._to_8bit_levels(jts._decayed(
            sj, jnp.float32(0.16), 0.03, ignore_polarity)[0],
            ignore_polarity))
        lvl_t = tts._to_8bit_levels(tts._decayed(
            st, torch.tensor(0.16), 0.03, ignore_polarity)[0],
            ignore_polarity).numpy()
        _assert_levels(lvl_t, lvl_j)
        assert np.abs(got - want).max() <= 1.0 + 1e-4
        assert (np.abs(got - want) <= 1e-4).mean() >= 0.999


def test_render_forward_and_roll_ticks():
    rng = np.random.default_rng(2)
    rj = _distorted_rig_jax()
    rt = convert.rig_from_numpy(convert.rig_to_numpy(rj), device="cpu")
    K, n = 3, 300
    frames = [_events(rng, n, 0.04 * k, 0.04 * (k + 1)) for k in range(K)]
    stack = [np.stack([f[i] for f in frames]) for i in range(5)]
    ticks = np.array([0.04, 0.08, 0.12], np.float32)
    for mode in ("backward", "forward"):
        cj = jts.TimeSurfaceConfig(mode=mode)
        ct = tts.TimeSurfaceConfig(mode=mode)
        sj, surf_j = jts.roll_ticks(
            jts.init_state(H, W), jts.EventBatch.from_arrays(*stack),
            jnp.asarray(ticks), rj.left, cj)
        st, surf_t = tts.roll_ticks(
            tts.init_state(H, W, device="cpu"),
            tts.EventBatch.from_arrays(*stack, device="cpu"),
            torch.from_numpy(ticks), rt.left, ct)
        np.testing.assert_array_equal(st.last_t_pos.numpy(),
                                      np.asarray(sj.last_t_pos))
        diff = np.abs(surf_t.numpy() - np.asarray(surf_j))
        assert diff.max() <= 1.0 + 1e-4
        assert (diff <= 1e-4).mean() >= 0.999


@pytest.mark.parametrize("k", [1, 2])
def test_median_blur(k):
    rng = np.random.default_rng(3)
    img = np.round(rng.uniform(0, 255, (H, W))).astype(np.float32)
    np.testing.assert_allclose(
        tts.median_blur(torch.from_numpy(img), k).numpy(),
        np.asarray(jts.median_blur(jnp.asarray(img), k)), atol=1e-5)


@pytest.mark.parametrize("ksize", [3, 5, 9])
def test_gaussian_and_sobel(ksize):
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    np.testing.assert_allclose(
        tts.gaussian_blur(torch.from_numpy(img), ksize).numpy(),
        np.asarray(jts.gaussian_blur(jnp.asarray(img), ksize)), atol=1e-5)
    for fn in ("sobel_x", "sobel_y"):
        np.testing.assert_allclose(
            getattr(tts, fn)(torch.from_numpy(img)).numpy(),
            np.asarray(getattr(jts, fn)(jnp.asarray(img))), atol=1e-5)


@pytest.mark.parametrize("ignore_polarity, median", [(True, 1), (False, 1),
                                                     (True, 0)])
def test_render_backward_pair_is_two_renders(ignore_polarity, median):
    """render_backward_pair equals render_backward per camera, bitwise, on
    the distorted rig, with two different states."""
    rng = np.random.default_rng(5)
    _, st_l = _insert_both(rng)
    _, st_r = _insert_both(rng)
    rt = convert.rig_from_numpy(convert.rig_to_numpy(_distorted_rig_jax()),
                                device="cpu")
    ct = tts.TimeSurfaceConfig(ignore_polarity=ignore_polarity,
                               median_blur_kernel_size=median)
    t = torch.tensor(0.16)
    left, right = tts.render_backward_pair(st_l, st_r, t, rt.left, rt.right,
                                           ct)
    assert torch.equal(left, tts.render_backward(st_l, t, rt.left, ct))
    assert torch.equal(right, tts.render_backward(st_r, t, rt.right, ct))
    assert not torch.equal(left, right)
