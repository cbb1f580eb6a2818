"""Parity of kernel K1's plain twin (ops/patches.slice_patches_plain)
with the JAX Pallas window kernel in interpret mode (clamped STARTS),
and of the port's interp.slice_patches flat-gather path with JAX's
(clamped ELEMENTS). Both bit-exact."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.ops import interp as jinterp
from esvo_tpu.ops.pallas_patches import pallas_slice_patches
from esvo_tpu_torch.ops import interp as tinterp
from esvo_tpu_torch.ops import patches as patches_op


@pytest.mark.parametrize("shape,h,w", [
    ((48, 64), 8, 7),
    ((180, 240), 24, 32),     # the depth solve's windows at rpg size
    ((60, 130), 8, 8),
])
def test_twin_matches_pallas_interpret(shape, h, w):
    rng = np.random.default_rng(3)
    H, W = shape
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    n = 37
    uy = rng.integers(-2, H + 2, n).astype(np.int32)   # incl. clamped starts
    ux = rng.integers(-2, W + 2, n).astype(np.int32)
    want = np.asarray(pallas_slice_patches(jnp.asarray(img), jnp.asarray(uy),
                                           jnp.asarray(ux), h, w, block=16,
                                           interpret=True))
    got = patches_op.slice_patches(torch.from_numpy(img),
                                   torch.from_numpy(uy),
                                   torch.from_numpy(ux), h, w).numpy()
    np.testing.assert_array_equal(got, want)
    assert (uy < 0).any() or (uy > H - h).any()


@pytest.mark.parametrize("h,w", [(8, 16), (16, 16), (3, 5)])
def test_flat_gather_matches_jax(h, w):
    """interp.slice_patches on a CPU tensor: per-element clamping, with
    batch dims preserved."""
    rng = np.random.default_rng(4)
    H, W = 40, 50
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    uy = rng.integers(-4, H + 2, (3, 11)).astype(np.int32)
    ux = rng.integers(-4, W + 2, (3, 11)).astype(np.int32)
    want = np.asarray(jinterp.slice_patches(jnp.asarray(img),
                                            jnp.asarray(uy),
                                            jnp.asarray(ux), h, w))
    got = tinterp.slice_patches(torch.from_numpy(img), torch.from_numpy(uy),
                                torch.from_numpy(ux), h, w).numpy()
    assert got.shape == (3, 11, h, w)
    np.testing.assert_array_equal(got, want)


def test_semantics_agree_in_range_differ_out_of_range():
    """The two clamping rules agree for in-range starts only."""
    img = torch.arange(20 * 30, dtype=torch.float32).reshape(20, 30)
    uy = torch.tensor([0, 4, 15, -3], dtype=torch.int32)
    ux = torch.tensor([0, 7, 20, 25], dtype=torch.int32)
    start = patches_op.slice_patches_plain(img, uy, ux, 5, 10)
    elem = tinterp.slice_patches(img, uy, ux, 5, 10)
    assert torch.equal(start[:3], elem[:3])
    assert not torch.equal(start[3], elem[3])


def test_patch_interpolate_and_bilinear_sample():
    rng = np.random.default_rng(6)
    H, W = 30, 40
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    loc = np.stack([rng.uniform(-2, W + 2, 60),
                    rng.uniform(-2, H + 2, 60)], 1).astype(np.float32)
    pj, okj = jinterp.patch_interpolate(jnp.asarray(img), jnp.asarray(loc),
                                        7, 15)
    pt, okt = tinterp.patch_interpolate(torch.from_numpy(img),
                                        torch.from_numpy(loc), 7, 15)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
    np.testing.assert_allclose(
        tinterp.bilinear_sample(torch.from_numpy(img),
                                torch.from_numpy(loc), fill=-1.0).numpy(),
        np.asarray(jinterp.bilinear_sample(jnp.asarray(img),
                                           jnp.asarray(loc), fill=-1.0)),
        atol=1e-4)
    yi = rng.integers(0, H, 20)
    xi = rng.integers(0, W, 20)
    np.testing.assert_array_equal(
        tinterp.gather2d(torch.from_numpy(img), torch.from_numpy(yi),
                         torch.from_numpy(xi)).numpy(),
        np.asarray(jinterp.gather2d(jnp.asarray(img), jnp.asarray(yi),
                                    jnp.asarray(xi))))


def _pair_inputs(rng, shape, n_a, n_b, h, w):
    H, W = shape
    imgs = [torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32))
            for _ in range(2)]
    starts = [torch.from_numpy(rng.integers(lo, hi + 3, n).astype(np.int32))
              for n in (n_a, n_b) for lo, hi in ((-3, H - h), (-3, W - w))]
    return imgs[0], starts[0], starts[1], imgs[1], starts[2], starts[3]


@pytest.mark.parametrize("n_a, n_b", [(37, 37), (5, 12), (0, 3), (0, 0)])
def test_pair_on_cpu_is_two_single_calls(n_a, n_b):
    """slice_patches_pair on CPU tensors: two calls of the twin, bitwise;
    the pair router equals two single routers (here the flat gather)."""
    h, w = 24, 32
    a_img, a_y, a_x, b_img, b_y, b_x = _pair_inputs(
        np.random.default_rng(7), (60, 80), n_a, n_b, h, w)
    before = patches_op.KERNEL.launches
    a, b = patches_op.slice_patches_pair(a_img, a_y, a_x, b_img, b_y, b_x,
                                         h, w)
    assert a.shape == (n_a, h, w) and b.shape == (n_b, h, w)
    assert torch.equal(a, patches_op.slice_patches_plain(a_img, a_y, a_x,
                                                         h, w))
    assert torch.equal(b, patches_op.slice_patches_plain(b_img, b_y, b_x,
                                                         h, w))
    ra, rb = tinterp.slice_patches_pair(a_img, a_y, a_x, b_img, b_y, b_x,
                                        h, w)
    assert torch.equal(ra, tinterp.slice_patches(a_img, a_y, a_x, h, w))
    assert torch.equal(rb, tinterp.slice_patches(b_img, b_y, b_x, h, w))
    assert patches_op.KERNEL.launches == before


def test_pair_router_keeps_batch_dims():
    rng = np.random.default_rng(8)
    img = torch.from_numpy(rng.uniform(0, 255, (40, 50)).astype(np.float32))
    uy = torch.from_numpy(rng.integers(-4, 42, (3, 11)).astype(np.int32))
    ux = torch.from_numpy(rng.integers(-4, 52, (2, 5)).astype(np.int32))
    a, b = tinterp.slice_patches_pair(img, uy, uy, img, ux, ux, 8, 16)
    assert a.shape == (3, 11, 8, 16) and b.shape == (2, 5, 8, 16)
    assert torch.equal(b, tinterp.slice_patches(img, ux, ux, 8, 16))


# --- kernel K1's launch plan (host arithmetic; no card needed) -------------
# (the window plan, the instantiation for a window shape, is the launcher's
# own: tests/test_torch_cuda.py checks it on the card)

@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1000, 2000, 20000, 123457])
@pytest.mark.parametrize("sms, blocks", [(132, 8), (132, 4), (1, 1)])
def test_launch_plan_grid(n, sms, blocks):
    """The grid is what the card holds at once, never more warps than
    windows, and n = 0 launches nothing."""
    grid = patches_op.patches_launch_plan(n, sms, blocks, 8)
    assert grid <= -(-n // 8)
    assert grid == min(-(-n // 8), sms * blocks)
    assert (grid == 0) == (n == 0)


def test_cpu_tensor_never_counts_a_launch():
    before = patches_op.KERNEL.launches
    img = torch.ones(30, 40)
    uy = torch.zeros(4, dtype=torch.int32)
    patches_op.slice_patches(img, uy, uy, 24, 32)
    tinterp.slice_patches(img, uy, uy, 24, 32)
    assert patches_op.KERNEL.launches == before
