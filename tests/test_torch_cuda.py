"""Each hand-written CUDA kernel against its plain PyTorch twin on the card,
at the rpg shapes (240x180 surfaces, N = 1000 events, 24x32 windows).

Run on a machine with an NVIDIA GPU:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``tests/conftest.py`` imports JAX, which such a machine need not have).
Without one every test skips. The checks are chip_smoke.py's:
K1 bit-exact, K3 within atol 1e-5, K2 at the LM tolerances of
tests/test_torch_lm.py on at least 98% of the events.
"""
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    import chip_smoke
    from esvo_tpu_torch.ops import _build
    _build.build(["remap.cu", "patches.cu", "lm.cu"])
    return chip_smoke


@pytest.fixture(scope="module")
def rig(smoke):
    return smoke.make_rig("rpg", "cuda")


def test_remap_kernel(smoke, rig):
    before = smoke.remap.KERNEL.launches
    res = smoke.check_remap(rig, iters=5)
    assert res["max_abs_err"] <= 1e-5
    assert smoke.remap.KERNEL.launches > before


def test_patches_kernel(smoke, rig):
    res = smoke.check_patches(rig, 1000, iters=5)
    assert res["max_abs_err"] == 0.0


@pytest.mark.parametrize("ls_norm", ["Tdist", "l2"])
def test_lm_kernel(smoke, rig, ls_norm):
    cfg = smoke.MappingCycleConfig.from_dict(
        dict(smoke.RPG, depth=dict(smoke.RPG["depth"], ls_norm=ls_norm)))
    res = smoke.check_lm(rig, cfg, 1000, 8, iters=2)
    assert res["evaluations"] >= 1000
    assert min(res["within_tol"].values()) >= 0.98


def test_cuda_tensor_never_takes_the_twin(smoke, rig):
    """A CUDA tensor the kernel does not take raises; nothing falls back."""
    img = torch.zeros(180, 240, dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError):
        smoke.remap.remap(img, rig.left.inv_map)
    with pytest.raises(ValueError):
        smoke.patches.slice_patches(
            torch.zeros(10, 10, device="cuda"),
            torch.zeros(3, dtype=torch.int32, device="cuda"),
            torch.zeros(3, dtype=torch.int32, device="cuda"), 24, 32)
