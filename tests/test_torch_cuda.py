"""Each hand-written CUDA kernel against its plain PyTorch twin on the card,
at the rpg shapes (240x180 surfaces, N = 1000 events, 24x32 windows), and
kernel K2 also at the DSEC shape (N = 10000), at patch sizes that give 1,
4 and 8 pixels a lane, at edge event counts, and across repeat launches.

Run on a machine with an NVIDIA GPU:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``tests/conftest.py`` imports JAX, which such a machine need not have).
Without one every test skips. The checks are chip_smoke.py's:
K1 bit-exact, K3 within atol 1e-5, K2 at the LM tolerances of
tests/test_torch_lm.py on at least 98% of the events.
"""
import ctypes

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


@pytest.fixture(scope="module")
def dsec_rig(smoke):
    return smoke.make_rig("dsec", "cuda")


def _cfg(smoke, preset, **depth):
    return smoke.MappingCycleConfig.from_dict(
        dict(preset, depth=dict(preset["depth"], **depth)))


def test_lm_kernel_dsec_shape(smoke, dsec_rig):
    res = smoke.check_lm(dsec_rig, _cfg(smoke, smoke.DSEC), 10000, 40,
                         iters=2)
    assert res["evaluations"] >= 10000
    assert min(res["within_tol"].values()) >= 0.98
    assert res["plan"]["grid"] <= 10000 // 8


@pytest.mark.parametrize("px, py, kpl", [(5, 5, 1), (15, 7, 4), (17, 15, 8)])
def test_lm_kernel_patch_sizes(smoke, dsec_rig, px, py, kpl):
    """Each instantiation width against the twin, on the DSEC world at
    N = 1000. (On the rpg world the share of events
    within tolerance sits around the 98% bar at every patch size, the
    presets' 15x7 included, through the accept test's float32 races; the
    DSEC world clears it at every patch size.)"""
    assert smoke.lm.patch_kpl(py, px) == kpl
    cfg = _cfg(smoke, smoke.DSEC, patch_size_x=px, patch_size_y=py)
    res = smoke.check_lm(dsec_rig, cfg, 1000, 40, iters=2)
    assert res["plan"]["instantiation"] == f"lm_kernel<{kpl}, true>"
    assert min(res["within_tol"].values()) >= 0.98


def _first(args, n):
    """The kernel's inputs of the first n events."""
    args = list(args)
    for i in range(3, 10):           # u, v, d_init and the window origins
        args[i] = args[i][:n].contiguous()
    args[10] = args[10][:, :n].contiguous()     # rows (12, N)
    args[11] = args[11][:n].contiguous()        # windows (N, Wy, Wx)
    args[12] = args[12][:n].contiguous()
    return args


@pytest.mark.parametrize("n", [0, 1, 13, 1001])
def test_lm_kernel_event_counts(smoke, rig, n):
    """An event's result does not depend on N or on the warp that took
    it: the first n events alone give the bits of the same events in a
    launch of 1200."""
    args, kw = smoke.lm_world(rig, _cfg(smoke, smoke.RPG), 1200, 8, seed=5)
    full = smoke.lm.lm_solve(*args, **kw)
    work = torch.zeros(3, dtype=torch.int64, device="cuda")
    before = smoke.lm.KERNEL.launches
    got = smoke.lm.lm_solve(*_first(args, n), **kw, work=work)
    torch.cuda.synchronize()
    for a, b in zip(got, full):
        assert a.shape == (n,)
        assert torch.equal(a, b[:n])
    evals = int(work[0])
    assert (evals == 0) if n == 0 else (n <= evals <= 11 * n)
    assert smoke.lm.KERNEL.launches == before + (n > 0)


@pytest.mark.parametrize("ls_norm", ["Tdist", "l2"])
def test_lm_kernel_repeat_launch_is_bitwise(smoke, dsec_rig, ls_norm):
    args, kw = smoke.lm_world(dsec_rig, _cfg(smoke, smoke.DSEC,
                                             ls_norm=ls_norm), 10000, 40,
                              seed=6)
    outs, works = [], []
    for _ in range(2):
        work = torch.zeros(3, dtype=torch.int64, device="cuda")
        outs.append(smoke.lm.lm_solve(*args, **kw, work=work))
        works.append(work)
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert torch.equal(works[0], works[1])


def test_lm_fast_division_is_ieee(smoke):
    """The kernel's branch-free division (div_rn) gives the IEEE quotient
    bit for bit on operands in its range: random exponents over the whole
    range, divisors with all-ones mantissas, exact multiples, and the scale
    fixed point's own operand ranges."""
    from esvo_tpu_torch.ops import _build
    fn = _build._load("lm.cu").esvo_lm_div_check
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(7)
    n = 1 << 22

    def rand_f(lo, hi):
        m = torch.randint(0, 1 << 23, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
        e = torch.randint(lo + 127, hi + 128, (n,), generator=gen,
                          device="cuda", dtype=torch.int32)
        return ((e << 23) | m).view(torch.float32)

    uni = lambda: torch.rand(n, generator=gen, device="cuda")
    b_ones = (rand_f(-60, 59).view(torch.int32) | 0x7FFFFF).view(
        torch.float32)
    b_small = rand_f(-10, 10)
    cases = [(rand_f(-60, 59), rand_f(-60, 59)),
             (rand_f(-60, 59), b_ones),
             (b_small * torch.randint(1, 1 << 12, (n,), generator=gen,
                                      device="cuda").float(), b_small),
             (uni() ** 4 * 5e5, 10 ** (uni() * 7 - 3))]
    for a, b in cases:
        q_fast, q_ieee = torch.empty_like(a), torch.empty_like(a)
        in_range = torch.empty(n, dtype=torch.int32, device="cuda")
        assert fn(a.data_ptr(), b.data_ptr(), q_fast.data_ptr(),
                  q_ieee.data_ptr(), in_range.data_ptr(), n,
                  torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
        ok = in_range.bool()
        assert ok.float().mean() > 0.99
        assert torch.equal(q_fast.view(torch.int32)[ok],
                           q_ieee.view(torch.int32)[ok])


def test_lm_launch_plan_on_the_card(smoke):
    """The kernel's shared memory a block (each of 8 warps holds two 24x32
    windows and an mbarrier), its occupancy, and a grid that never exceeds
    what the card holds at once."""
    lm = smoke.lm
    info = lm.kernel_info(4, True, 24, 32)
    assert info["warps"] == 8
    assert info["smem_bytes"] == 8 * (2 * 24 * 32 * 4 + 8)
    assert info["blocks_per_sm"] >= 1
    assert 0 < info["registers"] <= 255
    plan = lm.lm_launch_plan(7, 15, 24, 32, 10 ** 6, info["sms"],
                             info["blocks_per_sm"], info["warps"])
    assert plan["grid"] == info["sms"] * info["blocks_per_sm"]
    with pytest.raises(RuntimeError):    # 8 warps x 2 x 64x64 f32 > 227 KB
        lm.kernel_info(4, True, 64, 64)
