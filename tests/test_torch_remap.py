"""Parity of kernel K3's plain twin (ops/remap.remap_plain) with the JAX
package's fixed-map remap: the Pallas kernel in interpret mode and the
XLA gather path, on the cases of tests/test_pallas_remap.py (rotation
maps, out-of-bounds maps with exact zeros, odd sizes, a real
distortion + rectification map). Tolerance atol 1e-5."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.geometry import camera as jcam
from esvo_tpu.ops.pallas_remap import remap_fixed_map
from esvo_tpu_torch.ops import remap as remap_op


def _rot_map(H, W, angle=0.04, scale=1.02, shift=(0.3, -0.7)):
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    cx, cy = W / 2, H / 2
    ca, sa = np.cos(angle), np.sin(angle)
    xs = scale * (ca * (xx - cx) - sa * (yy - cy)) + cx + shift[0]
    ys = scale * (sa * (xx - cx) + ca * (yy - cy)) + cy + shift[1]
    return np.stack([xs, ys], -1).astype(np.float32)


def _both(img, m):
    """(port twin, JAX Pallas interpret, JAX XLA gather)."""
    got = remap_op.remap(torch.tensor(img), torch.tensor(m)).numpy()
    pallas = np.asarray(remap_fixed_map(jnp.asarray(img, jnp.float32), m,
                                        interpret=True))
    xla = np.asarray(jcam.remap_bilinear(jnp.asarray(img, jnp.float32),
                                         jnp.asarray(m, jnp.float32)))
    return got, pallas, xla


@pytest.mark.parametrize("shape", [(40, 56), (48, 128), (37, 61)])
def test_rotation_maps(shape):
    H, W = shape
    rng = np.random.default_rng(3)
    img = rng.random((H, W)).astype(np.float32)
    got, pallas, xla = _both(img, _rot_map(H, W))
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    np.testing.assert_allclose(got, xla, atol=1e-5)


def test_out_of_bounds_exact_zero():
    H, W = 32, 48
    rng = np.random.default_rng(4)
    img = (rng.random((H, W)) + 0.5).astype(np.float32)
    m = _rot_map(H, W, angle=0.3, scale=1.6)
    got, pallas, xla = _both(img, m)
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    np.testing.assert_allclose(got, xla, atol=1e-5)
    outside = ((m[..., 0] <= -1) | (m[..., 0] >= W)
               | (m[..., 1] <= -1) | (m[..., 1] >= H))
    assert outside.any()
    assert np.all(got[outside] == 0.0)


def test_real_rectification_map():
    rng = np.random.default_rng(5)
    H, W = 36, 44
    params = jcam.PinholeParams(
        K=jnp.array([[40.0, 0, W / 2 - 0.5], [0, 40.0, H / 2 - 0.5],
                     [0, 0, 1.0]], jnp.float32),
        D=jnp.array([-0.3, 0.1, 1e-3, -1e-3], jnp.float32),
        R=jnp.eye(3, dtype=jnp.float32),
        P=jnp.array([[38., 0, W / 2, 0], [0, 38., H / 2, 0], [0, 0, 1, 0]],
                    jnp.float32),
        width=W, height=H, model="plumb_bob")
    inv = np.asarray(jcam.inverse_rectification_map(params), np.float32)
    img = rng.random((H, W)).astype(np.float32)
    got, pallas, xla = _both(img, inv)
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    np.testing.assert_allclose(got, xla, atol=1e-5)


def test_cpu_tensor_never_counts_a_launch():
    """On a CPU tensor the wrapper runs the twin, not the kernel."""
    before = remap_op.KERNEL.launches
    img = torch.ones(8, 9)
    m = torch.from_numpy(_rot_map(8, 9))
    remap_op.remap(img, m)
    assert remap_op.KERNEL.launches == before


@pytest.mark.parametrize("shape", [(40, 56), (37, 61)])
def test_pair_on_cpu_is_two_single_calls(shape):
    """remap_pair on CPU tensors: two calls of the twin, bitwise, on two
    images through two maps."""
    H, W = shape
    rng = np.random.default_rng(6)
    imgs = [torch.from_numpy(rng.random((H, W)).astype(np.float32))
            for _ in range(2)]
    maps = [torch.from_numpy(_rot_map(H, W, angle=a, scale=s))
            for a, s in ((0.04, 1.02), (-0.3, 1.6))]
    before = remap_op.KERNEL.launches
    a, b = remap_op.remap_pair(imgs[0], maps[0], imgs[1], maps[1])
    assert torch.equal(a, remap_op.remap(imgs[0], maps[0]))
    assert torch.equal(b, remap_op.remap(imgs[1], maps[1]))
    assert torch.equal(b, remap_op.remap_plain(imgs[1], maps[1], 0.0))
    assert remap_op.KERNEL.launches == before


@pytest.mark.parametrize("shape", [(180, 240), (37, 61), (260, 346), (1, 3)])
def test_pair_outputs_are_16_byte_aligned(shape):
    """The pair's two outputs share one buffer; each starts on a 16-byte
    boundary (the kernel's vector stores), whatever H*W mod 4 is."""
    H, W = shape
    a, b = remap_op.pair_outputs(H, W, "cpu")
    assert a.shape == b.shape == (H, W)
    assert a.is_contiguous() and b.is_contiguous()
    assert a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    assert b.data_ptr() - a.data_ptr() >= 4 * H * W


@pytest.mark.parametrize("shapes, fill", [
    (((40, 56), (40, 56)), 0.0),      # what a render tick sends
    (((40, 56), (40, 56)), 0.5),      # a nonzero fill never takes K3
    (((40, 56), (37, 61)), 0.0),      # two shapes: two single calls
])
def test_remap_bilinear_pair_is_two_single_routes(shapes, fill):
    """camera.remap_bilinear_pair on CPU tensors equals two
    remap_bilinear calls bitwise and the JAX package's remap_bilinear, and
    launches nothing."""
    from esvo_tpu_torch.geometry import camera as tcam
    rng = np.random.default_rng(7)
    imgs = [rng.random(s).astype(np.float32) for s in shapes]
    maps = [_rot_map(*s, angle=a, scale=k)
            for s, (a, k) in zip(shapes, ((0.04, 1.02), (-0.3, 1.6)))]
    t = [torch.from_numpy(x) for x in imgs + maps]
    before = remap_op.KERNEL.launches
    pair = tcam.remap_bilinear_pair(t[0], t[2], t[1], t[3], fill=fill)
    assert remap_op.KERNEL.launches == before
    for k in range(2):
        assert torch.equal(pair[k], tcam.remap_bilinear(t[k], t[k + 2],
                                                        fill=fill))
        want = jcam.remap_bilinear(jnp.asarray(imgs[k]),
                                   jnp.asarray(maps[k]), fill=fill)
        np.testing.assert_allclose(pair[k].numpy(), np.asarray(want),
                                   atol=1e-5)
