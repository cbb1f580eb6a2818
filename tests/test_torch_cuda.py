"""Each hand-written CUDA kernel against its plain PyTorch twin on the card,
at the rpg shapes (240x180 surfaces, N = 1000 events, 24x32 windows), and
kernel K2 also at the DSEC shape (N = 10000), at patch sizes that give 1,
4 and 8 pixels a lane, at edge event counts, and across repeat launches.
Kernels K1 and K3 single and as pairs (two surfaces / two cameras in one
launch) at the rpg, DSEC and DAVIS346 shapes, K1 at window shapes where a
lane owns more or less than one column and at edge window counts, K3 on
a shape whose pixel count is no multiple of 4.

The closed loop: one tracking solve and one tracked process_ticks roll
after the SGM bootstrap, card against the CPU port on the same inputs
(the same surface and the same selected points), at the tolerance of
the CPU parity tests (1e-4 m, 1e-4 rad).

The caller's float32 matmul precision "high" does not reach the
tracking solve (it still agrees with the CPU port) and holds afterwards.
K1 at the event matcher's 16x16 windows, and MVStereo mode 0 launching
it.

The resident loop: one roll captured as a CUDA graph and replayed twice
from a restored state, each replay against the roll run eagerly (1e-4 m,
1e-4 rad, map points and accept flags exact), a capture error that
raises instead of running the roll eagerly, and the tracer's spans of a
capture and of each replay (none from inside a capture).

The live path's WORKING cycle (``MappingCycle.working_cycle``, one CUDA
graph a cycle): over consecutive mapping ticks with a world correction,
a degrade and re-bootstrap and a second frame capacity, each replay's
window, grid, map points, occupancy and counters bit for bit the stages
called eagerly on the same inputs, no eager K2 launch on a replay, one
capture a capacity; published tensors never overwritten; a capture
error that raises and keeps no graph.

The live tick's body (``EsvoSystem._tick_static``, one CUDA graph a
tick): the rpg closed loop through process_tick (the bootstrap, tracked
and mapping ticks, a world correction, a watchdog reset) and DSEC's
known-pose run, each tick's surfaces, kept states, pose, rms and point
count bit for bit a second system's eager ticks; nothing host-side baked
into a capture; published states and surfaces never overwritten; a
replay a tick, one capture a body, no eager tick.

The backend: the loop-closure descriptor, the ICP verification, bundle
adjustment and the pose graph on the card against the CPU port, BA, the
pose graph and their segment sums the same bits on every run, and one
chunk of the event simulator's substeps (chip_smoke.py's cases).

The event-axis sharding at world 1 on NCCL (one spawned rank): the
surface update and the map estimate at rpg and DSEC sizes bit for bit the
unsharded calls on the card.

The port-only kernels: K4 (the tracker's LM scan) against solve_plain
at the rpg and DSEC surfaces (pose within 1e-4 m and 1e-4 rad) and two
launches bit for bit, also on maps whose trailing batches hold no valid
point (the rounds K4 skips write rms 0); K5 (regularization) bit for
bit regularize_plain at r = 5 and r = 20 in both norms, on every
occupancy pattern of chip_smoke.regularize_world (empty, full, the four
corners, an edge-like grid with NaN and infinite inverse depths) and
across repeat launches; neither solve nor regularize takes
its twin on a CUDA tensor; one K4 launch a tick inside a resident
replay. A float64 grid regularizes on the card through regularize_plain
(K5 takes float32 only), equal to the CPU's. K6 (block matching's
disparity scan) and K7 (the fusion fold) bit for bit their twins at the
rpg and DSEC shapes (chip_smoke's checks), bitwise across repeat
launches; neither match_events_stats nor fuse_frame takes its twin on a
CUDA float32 tensor (fuse_frame runs no rank and no slot plane: K7
places the slots from the sorted runs); one K6 and one K7 launch inside
a resident replay. K6's instantiations (7x15 and 15x7 at 1-5
disparities a lane and two passes, the generic one) bit for bit the
twin, each without spills; K7's run bounds and drop count equal
run_bounds' and _assign_slots', also where a block's stretch of the
sorted order is searched in L2.

Run on a machine with an NVIDIA GPU:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``tests/conftest.py`` imports JAX, which such a machine need not have).
Without one every test skips. The checks are chip_smoke.py's:
K1 and K3 bit-exact, K2 at the LM tolerances of
tests/test_torch_lm.py on at least 98% of the events.
"""
import ctypes
import math

import numpy as np
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
    _build.build(["remap.cu", "patches.cu", "lm.cu", "track.cu",
                  "regularize.cu", "block_match.cu", "fuse.cu"])
    # while this file's tests run, tear CUPTI down after each profiler
    # session: left up, graphs captured between the file's sessions (the
    # resident and live-cycle tests) crashed a later profiled replay in
    # CUPTI (test_resident_replay_launches_k4_once_a_tick, torch 2.11,
    # CUDA 12.8)
    with pytest.MonkeyPatch.context() as env:
        env.setenv("TEARDOWN_CUPTI", "1")
        yield chip_smoke


@pytest.fixture(scope="module")
def rig(smoke):
    return smoke.make_rig("rpg", "cuda")


def test_remap_kernel(smoke, rig):
    before = smoke.remap.KERNEL.launches
    res = smoke.check_remap(rig, iters=5)
    assert res["max_abs_err"] == 0.0
    assert smoke.remap.KERNEL.launches > before


def test_patches_kernel(smoke, rig):
    res = smoke.check_patches(rig, 1000, iters=5)
    assert res["max_abs_err"] == 0.0


@pytest.mark.parametrize("ls_norm", ["Tdist", "l2"])
def test_lm_kernel(smoke, rig, ls_norm):
    cfg = smoke.SystemConfig.from_dict(
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
    return smoke.SystemConfig.from_dict(
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


def test_lm_launch_after_a_rejected_shape(smoke, rig):
    """A shape kernel_info rejects leaves no CUDA error behind for the
    next launch to report (each kernel library has its own runtime)."""
    with pytest.raises(RuntimeError):
        smoke.lm.kernel_info(4, True, 64, 64)
    args, kw = smoke.lm_world(rig, _cfg(smoke, smoke.RPG), 64, 8, seed=5)
    d, _, _ = smoke.lm.lm_solve(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(d).all()


# --- K1 and K3 single and pair --------------------------------------------

def _k1_inputs(shape, n, h, w, seed):
    H, W = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand((H, W), generator=gen, device="cuda") * 255
    uy = torch.randint(-4, H - h + 4, (n,), generator=gen, device="cuda",
                       dtype=torch.int32)
    ux = torch.randint(-4, W - w + 4, (n,), generator=gen, device="cuda",
                       dtype=torch.int32)
    return img, uy, ux


def _k1_against_twin(smoke, a, b, h, w):
    """Single on a, pair on (a, b): each bitwise the twin's, one launch
    each where there are windows."""
    op = smoke.patches
    before = op.KERNEL.launches
    single = op.slice_patches(*a, h, w)
    pair = op.slice_patches_pair(*a, *b, h, w)
    torch.cuda.synchronize()
    assert torch.equal(single, op.slice_patches_plain(*a, h, w))
    assert torch.equal(pair[0], op.slice_patches_plain(*a, h, w))
    assert torch.equal(pair[1], op.slice_patches_plain(*b, h, w))
    assert pair[0].is_contiguous() and pair[1].is_contiguous()
    na, nb = a[1].shape[0], b[1].shape[0]
    assert op.KERNEL.launches == before + (na > 0) + (na + nb > 0)


@pytest.mark.parametrize("shape, n", [((180, 240), 1000),
                                      ((480, 640), 10000),
                                      ((260, 346), 2000)])    # DAVIS346
def test_patches_single_and_pair(smoke, shape, n):
    _k1_against_twin(smoke, _k1_inputs(shape, n, 24, 32, 11),
                     _k1_inputs(shape, n, 24, 32, 12), 24, 32)


@pytest.mark.parametrize("h, w", [(16, 16), (8, 40), (8, 9), (64, 64),
                                  (40, 100), (16, 33), (8, 1024)])
def test_patches_window_shapes(smoke, h, w):
    """Runs of 4 columns that wrap rows (16x16, 8x40), single columns
    (8x9, 16x33), and windows of several bands (64x64, 40x100, 8x1024)."""
    shape = (max(180, h + 8), max(240, w + 8))
    _k1_against_twin(smoke, _k1_inputs(shape, 700, h, w, 13),
                     _k1_inputs(shape, 333, h, w, 14), h, w)


@pytest.mark.parametrize("n_a, n_b", [(0, 0), (1, 0), (0, 1), (1, 1),
                                      (13, 1001), (1000, 7)])
def test_patches_window_counts(smoke, n_a, n_b):
    _k1_against_twin(smoke, _k1_inputs((180, 240), n_a, 24, 32, 15),
                     _k1_inputs((180, 240), n_b, 24, 32, 16), 24, 32)


def test_patches_starts_clamp_on_all_sides(smoke):
    H, W, h, w = 180, 240, 24, 32
    ys = [-10 ** 6, -1, 0, 5, H - h, H - h + 1, 10 ** 6]
    xs = [-10 ** 6, -1, 0, 7, W - w, W - w + 1, 10 ** 6]
    grid = torch.tensor([(y, x) for y in ys for x in xs], dtype=torch.int32,
                        device="cuda")
    img = _k1_inputs((H, W), 0, h, w, 17)[0]
    a = (img, grid[:, 0].contiguous(), grid[:, 1].contiguous())
    b = (img.flip(0).contiguous(), grid[:, 1].contiguous(),
         grid[:, 0].contiguous())
    _k1_against_twin(smoke, a, b, h, w)


def test_patches_repeat_launch_is_bitwise(smoke):
    a = _k1_inputs((480, 640), 10000, 24, 32, 18)
    b = _k1_inputs((480, 640), 10000, 24, 32, 19)
    first = smoke.patches.slice_patches_pair(*a, *b, 24, 32)
    again = smoke.patches.slice_patches_pair(*a, *b, 24, 32)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_patches_launch_plan_on_the_card(smoke):
    """The presets' instantiation spills nothing, fits at least one block
    an SM, and its grid never exceeds what the card holds at once."""
    op = smoke.patches
    info = op.kernel_info(24, 32)
    assert info["name"] == "slice_patches_kernel<6, 4>"
    assert info["blocks_per_sm"] >= 1 and info["local_bytes"] == 0
    grid = op.patches_launch_plan(10 ** 6, info["sms"], info["blocks_per_sm"],
                                  info["warps"])
    assert grid == info["sms"] * info["blocks_per_sm"]


@pytest.mark.parametrize("h, w, rpl, vec, band_rows", [
    (24, 32, 6, 4, 24),      # the presets' windows: 6 runs of 4 a lane
    (16, 16, 2, 4, 16),      # a warp step covers 8 rows
    (8, 40, 3, 4, 8),        # a lane's runs wrap across rows
    (8, 9, 3, 1, 8),         # single columns, a partial last lane slot
    (16, 33, 17, 1, 16),
    (64, 64, 8, 4, 16),      # taller than one band: 4 bands of 16 rows
    (40, 100, 8, 4, 10),     # 4 bands of 10 rows, the last lane slots idle
    (3, 1024, 8, 4, 1),      # one row a band
    (2, 1023, 32, 1, 1),
])
def test_window_plan_on_the_card(smoke, h, w, rpl, vec, band_rows):
    """The launcher's window plan: runs of 4 columns where w % 4 == 0,
    bands that fit 32 floats a lane, ceil(runs / 32) runs a lane."""
    info = smoke.patches.kernel_info(h, w)
    assert (info["rpl"], info["vec"], info["band_rows"]) == (rpl, vec,
                                                             band_rows)
    runs = band_rows * w // vec
    assert runs <= 32 * rpl < runs + 32
    assert rpl * vec <= 32


@pytest.mark.parametrize("h, w", [(8, 1025), (8, 1028), (0, 8), (8, 0)])
def test_window_plan_rejects_on_the_card(smoke, h, w):
    with pytest.raises(ValueError):
        smoke.patches.kernel_info(h, w)


def _rot_map(H, W, angle, scale):
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float64),
                            torch.arange(W, dtype=torch.float64),
                            indexing="ij")
    cx, cy = W / 2, H / 2
    ca, sa = math.cos(angle), math.sin(angle)
    xs = scale * (ca * (xx - cx) - sa * (yy - cy)) + cx + 0.3
    ys = scale * (sa * (xx - cx) + ca * (yy - cy)) + cy - 0.7
    return torch.stack([xs, ys], -1).float().cuda()


@pytest.mark.parametrize("shape", [(180, 240), (480, 640), (260, 346),
                                   (37, 61)])
def test_remap_single_and_pair(smoke, shape):
    """Bitwise the twin's on both cameras, with maps that leave the image
    (exact zeros) and a pixel count that is no multiple of 4 (37x61)."""
    H, W = shape
    op = smoke.remap
    gen = torch.Generator(device="cuda").manual_seed(20)
    img_a, img_b = (torch.randint(0, 256, (H, W), generator=gen,
                                  device="cuda").float() for _ in range(2))
    map_a, map_b = _rot_map(H, W, 0.04, 1.02), _rot_map(H, W, -0.3, 1.6)
    before = op.KERNEL.launches
    single = op.remap(img_a, map_a)
    pair = op.remap_pair(img_a, map_a, img_b, map_b)
    again = op.remap_pair(img_a, map_a, img_b, map_b)
    torch.cuda.synchronize()
    want = (op.remap_plain(img_a, map_a, 0.0),
            op.remap_plain(img_b, map_b, 0.0))
    assert torch.equal(single, want[0])
    assert all(torch.equal(x, y) for x, y in zip(pair, want))
    assert all(torch.equal(x, y) for x, y in zip(pair, again))
    assert (want[1] == 0).any()
    assert op.KERNEL.launches == before + 3


def test_remap_rejects_a_misaligned_map(smoke):
    H, W = 37, 61
    img = torch.zeros(H, W, device="cuda")
    flat = torch.zeros(H * W * 2 + 1, device="cuda")
    with pytest.raises(ValueError):
        smoke.remap.remap(img, flat[1:].view(H, W, 2))


def test_render_tick_is_one_remap_launch(smoke, rig):
    """A backward render tick rectifies both surfaces in one K3 launch."""
    cfg = smoke.SystemConfig.from_dict(smoke.RPG)
    cycle = smoke.MappingCycle(rig, cfg, device="cuda")
    st = [smoke.tsf.init_state(cycle.H, cycle.W, "cuda") for _ in range(2)]
    ev = smoke.tsf.EventBatch.from_arrays([3, 4], [5, 6], [0.001, 0.002],
                                          [True, False], device="cuda")
    before = smoke.remap.KERNEL.launches
    out = cycle.render_tick(*st, ev, ev, 0.01)
    assert smoke.remap.KERNEL.launches == before + 1
    cams = (cycle.rig.left, cycle.rig.right)
    for s, surf, cam in zip(out[:2], out[2:], cams):
        assert torch.equal(surf, smoke.tsf.render_backward(s, torch.tensor(
            0.01, device="cuda"), cam, cfg.surface))


# --- the closed loop ---------------------------------------------------------

@pytest.fixture(scope="module")
def booted(smoke, rig):
    """An rpg EsvoSystem on the card and one through the CPU port, each
    after the same first roll (the SGM bootstrap)."""
    from esvo_tpu_torch import convert
    cfg = smoke.SystemConfig.from_dict(smoke.RPG)
    cpu_rig = convert.rig_from_numpy(convert.rig_to_numpy(rig), device="cpu")
    scene, ticks, frames = smoke.make_stream("rpg", rig, n_ticks=12)
    systems = {"cuda": smoke.EsvoSystem(rig, cfg, device="cuda"),
               "cpu": smoke.EsvoSystem(cpu_rig, cfg, device="cpu")}
    outs = {dev: s.process_ticks(*smoke._roll_inputs(frames, ticks, 0))
            for dev, s in systems.items()}
    return systems, outs, (ticks, frames), cfg, cpu_rig


def test_closed_loop_roll_card_vs_cpu(smoke, booted):
    systems, outs, (ticks, frames), _, _ = booted
    card, cpu = systems["cuda"], systems["cpu"]
    n_card, n_cpu = outs["cuda"]["sgm_points"], outs["cpu"]["sgm_points"]
    assert abs(n_card - n_cpu) <= 0.01 * n_cpu and n_cpu >= 500
    assert card.status.value == cpu.status.value == "WORKING"
    chosen = {}
    pick = card.select_ref_points

    def spy(pts, ok):
        chosen["sel"] = pick(pts, ok)
        return chosen["sel"]

    card.select_ref_points = spy
    cpu.select_ref_points = lambda pts, ok: tuple(a.cpu()
                                                  for a in chosen["sel"])
    before = smoke.remap.KERNEL.launches
    roll = smoke._roll_inputs(frames, ticks, smoke.ROLL)
    out_card = card.process_ticks(*roll, do_mapping=False)
    out_cpu = cpu.process_ticks(*roll, do_mapping=False)
    # one K3 launch a tracked tick, one pair launch for the roll's end
    assert smoke.remap.KERNEL.launches == before + smoke.ROLL + 1
    for a, b in zip(out_card["poses"], out_cpu["poses"]):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 1e-4
        assert smoke.pose_angle(a[:3, :3], b[:3, :3]) < 1e-4


def test_tracking_solve_card_vs_cpu(smoke, booted):
    systems, _, _, cfg, cpu_rig = booted
    res = smoke.check_tracking_solve(systems["cuda"], cpu_rig, cfg)
    assert res["points"] >= 300


def test_tracking_solve_under_callers_high_precision(smoke, booted):
    """The caller sets float32 matmul precision "high" (TF32): the
    guarded solve still agrees with the CPU port, and "high" holds
    afterwards."""
    systems, _, _, cfg, cpu_rig = booted
    saved = torch.get_float32_matmul_precision()
    try:
        res = smoke.check_precision(systems["cuda"], cpu_rig, cfg)
    finally:
        torch.set_float32_matmul_precision(saved)
    assert res["caller_precision_after"] == "high"


# --- the mapper benchmark ----------------------------------------------------

def test_patches_at_the_matchers_windows(smoke, rig):
    """K1 at the event matcher's 16x16 windows (15x15 patches), at the
    rpg mvstereo phase's count (1000 events x 30 slots): bit-exact with
    its twin, with a launch plan for the shape."""
    res = smoke.check_patches(rig, 30000, iters=3, h=16, w=16)
    assert res["max_abs_err"] == 0.0 and res["pair"]["max_abs_err"] == 0.0
    assert res["plan"]["grid"] > 0


def test_event_matching_mode_launches_k1(smoke, rig):
    """MVStereo mode 0 on the card sends the matcher's windows to K1
    (two launches a mapping cycle: one a surface) and no depth LM."""
    cfg = smoke.SystemConfig.from_dict(smoke.RPG)
    scene, ticks, frames = smoke.make_stream("rpg", rig, n_ticks=6)
    smoke.MV_TICKS, mv_ticks = 5, smoke.MV_TICKS
    before = (smoke.patches.KERNEL.launches, smoke.lm.KERNEL.launches)
    try:
        system, cycle_ms = smoke.run_mvstereo(
            rig, cfg, scene, ticks, frames,
            smoke.mv.MVStereoMode.PURE_EVENT_MATCHING)
    finally:
        smoke.MV_TICKS = mv_ticks
    assert len(cycle_ms) == 1 and system.stats["map_points"] > 0
    assert smoke.patches.KERNEL.launches == before[0] + 2
    assert smoke.lm.KERNEL.launches == before[1]


# --- the resident loop -------------------------------------------------------

@pytest.fixture(scope="module")
def resident(smoke, rig):
    """An rpg EsvoSystem on the card after its bootstrap roll, a resident
    loop (one roll a dispatch) started on it, and the next roll's
    inputs."""
    cfg = smoke.SystemConfig.from_dict(smoke.RPG)
    scene, ticks, frames = smoke.make_stream("rpg", rig, n_ticks=10)
    system = smoke.EsvoSystem(rig, cfg, device="cuda")
    system.process_ticks(*smoke._roll_inputs(frames, ticks, 0))
    assert system.status.value == "WORKING"
    loop = smoke.ResidentLoop(system, smoke.ROLL, 1)
    loop.start()
    return system, loop, smoke._roll_inputs(frames, ticks, smoke.ROLL)


def _assert_rolls_agree(smoke, got, want):
    for a, b in zip(got["poses"], want["poses"]):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 1e-4
        assert smoke.pose_angle(a[:3, :3], b[:3, :3]) < 1e-4
    assert got["map_points"] == want["map_points"]
    assert (got["accepted"] == want["accepted"]).all()


def test_resident_graph_replays_equal_the_eager_roll(smoke, resident):
    """Capture one roll; the warm-up moves neither the state nor the
    generator; two replays from the restored state each equal the roll
    run eagerly from a clone (1e-4 m, 1e-4 rad, map points and accept
    flags exact)."""
    system, loop, roll = resident
    snap = loop.state.map(torch.clone)
    gen_state = system._gen.get_state()
    gen = torch.Generator(device="cuda").manual_seed(5)
    scores = torch.rand(system.H * system.W, device="cuda", generator=gen)
    loop.stage(*roll, scores=scores)
    loop._capture()
    assert all(torch.equal(a, b) for a, b in zip(loop.state.tensors(),
                                                  snap.tensors()))
    assert torch.equal(system._gen.get_state(), gen_state)
    before = smoke.lm.KERNEL.launches
    replays = []
    for _ in range(2):
        loop.state.copy_(snap)
        replays.append(smoke.unpack(loop.step().cpu().numpy(), loop.K))
    assert smoke.lm.KERNEL.launches == before      # no eager launch
    eager = smoke.unpack(loop.roll(snap.map(torch.clone),
                                   loop.inputs)[1].cpu().numpy(), loop.K)
    for got in replays:
        _assert_rolls_agree(smoke, got, eager)
    assert eager["map_points"] > 0 and eager["accepted"].all()


def test_resident_capture_error_raises(smoke, resident):
    """A roll that syncs the host cannot be captured: the capture raises,
    no graph is kept, and the state is not advanced by an eager roll."""
    system, loop, roll = resident
    bad = smoke.ResidentLoop(system, smoke.ROLL, 1)
    bad.start()
    real_roll = bad.roll

    def roll_with_host_sync(st, inp):
        new, out = real_roll(st, inp)
        float(out.sum())           # a device-to-host copy
        return new, out

    bad.roll = roll_with_host_sync
    bad.stage(*roll)
    snap = bad.state.map(torch.clone)
    with pytest.raises(RuntimeError):
        bad.step()
    assert bad._graph is None
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(bad.state.tensors(),
                                                 snap.tensors()))
    bad.finish()


def test_resident_spans_on_the_card(smoke, resident):
    """With the tracer on, a new loop's first step records its capture
    (``resident.capture`` under ``resident.step``, ``graph.captures``)
    and every replay a ``resident.replay`` device span with its time; a
    device span opened while a graph captures records nothing."""
    from esvo_tpu_torch.utils import profiling as prof
    system, loop, roll = resident
    fresh = smoke.ResidentLoop(system, smoke.ROLL, 1)
    fresh.start()
    prof.enable()
    try:
        for _ in range(2):
            fresh.stage(*roll)
            fresh.step()
        graph, x = torch.cuda.CUDAGraph(), torch.zeros(4, device="cuda")
        with torch.cuda.graph(graph):
            with prof.device_span("inside.capture"):
                x.add_(1)
        got = prof.take()
    finally:
        prof.disable()
        prof.take()
    fresh.finish()
    spans = got["spans"]
    replays = [s for s in spans if s["name"] == "resident.replay"]
    assert len(replays) == 2
    assert all(s["parent"] == "resident.step" and s["device_ms"] > 0
               for s in replays)
    captures = [s for s in spans if s["name"] == "resident.capture"]
    assert len(captures) == 1 and captures[0]["parent"] == "resident.step"
    assert not any(s["name"] == "inside.capture" for s in spans)
    assert got["counters"] == {"graph.captures": 1, "resident.replays": 2,
                               "resident.ticks": 2 * smoke.ROLL}


# -- the live path's WORKING cycle as one CUDA graph -------------------------

LIVE_TICKS = 45


def _one(frames, k, pad: int = 0):
    """Tick k's frame of both cameras, with `pad` invalid lanes appended
    (a frame of another capacity)."""
    out = []
    for f in frames:
        ev = {key: v[k] for key, v in f.items() if key != "dropped"}
        out.append({key: np.concatenate([v, np.zeros(pad, v.dtype)])
                    for key, v in ev.items()})
    return out


def _same_bits(a, b) -> bool:
    """Equal bit for bit (NaN payloads included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = lambda t: t.contiguous().reshape(-1).view(torch.uint8)
    return torch.equal(view(a), view(b))


def _cycle_by_stages(cycle, hist, slot, ts_l, ts_r, ev, pose_times,
                     pose_tab, T_wf):
    """working_cycle's outputs through the cycle's stages called eagerly
    on the same inputs: (new window, grid, points, occupied, counters)."""
    dev = lambda a, dt=None: torch.as_tensor(np.asarray(a), dtype=dt,
                                             device="cuda")
    T = dev(T_wf, cycle.dtype)
    est, n, bm_stats = cycle.mapping_estimate(
        ts_l, ts_r, dev(ev["x"]), dev(ev["y"]), dev(ev["t"], cycle.dtype),
        dev(ev["valid"]), dev(pose_times, cycle.dtype),
        dev(pose_tab, cycle.dtype), T)
    hist = cycle.write_history(hist, est, torch.tensor(slot, device="cuda"))
    grid, pts, occ, nf, nd = cycle.rebuild_frame(hist, T)
    counters = torch.stack([c.to(torch.int64) for c in (
        n, *bm_stats.values(), nf, nd, torch.sum(occ))])
    return hist, grid, pts, occ, counters


@pytest.fixture(scope="module")
def live(smoke, rig):
    """An rpg EsvoSystem on the card run through process_tick after its
    bootstrap roll, every WORKING cycle held bit for bit against its
    stages called eagerly on the same inputs (``log``, a record a
    cycle), with a world correction between two cycles, a degrade and
    re-bootstrap, and a frame of a second capacity on tick 39. Returns
    (system, log, tracer counters, the tensors of system.history and
    system.grid after tick 14, each with a copy taken then)."""
    from esvo_tpu_torch.utils import profiling as prof
    cfg = smoke.SystemConfig.from_dict(smoke.RPG)
    scene, ticks, frames = smoke.make_stream("rpg", rig, n_ticks=LIVE_TICKS)
    system = smoke.EsvoSystem(rig, cfg, device="cuda")
    system.process_ticks(*smoke._roll_inputs(frames, ticks, 0))
    assert system.status.value == "WORKING"
    cycle, log = system.cycle, []
    real = cycle.working_cycle

    def spy(ts_l, ts_r, ev, pose_times, pose_tab, T_wf):
        hist, slot = cycle.history, cycle.hist_slot
        captured = sum(s.graph is not None for s in cycle._static.values())
        k2 = smoke.lm.KERNEL.launches, smoke.lm.KERNEL.replayed
        got = real(ts_l, ts_r, ev, pose_times, pose_tab, T_wf)
        rec = dict(captured=sum(s.graph is not None
                                for s in cycle._static.values()) - captured,
                   k2_launches=smoke.lm.KERNEL.launches - k2[0],
                   k2_replayed=smoke.lm.KERNEL.replayed - k2[1],
                   cap=len(ev["x"]))
        want = _cycle_by_stages(cycle, hist, slot, ts_l, ts_r, ev,
                                pose_times, pose_tab, T_wf)
        grid = [getattr(got[0], f) for f in vars(want[1])]
        rec["same"] = dict(
            window=all(_same_bits(a, b) for a, b in zip(
                vars(cycle.history).values(), vars(want[0]).values())),
            grid=all(_same_bits(a, b) for a, b in zip(
                grid, vars(want[1]).values())),
            points=_same_bits(got[1], want[2]),
            occupied=_same_bits(got[2], want[3]),
            counters=_same_bits(got[3], want[4]))
        rec["estimates"] = int(want[4][0])
        log.append(rec)
        return got

    cycle.working_cycle = spy
    kept = None
    prof.enable()
    try:
        for k in range(smoke.ROLL, LIVE_TICKS):
            if k == 29:
                system._degrade()         # re-bootstraps on this tick
            fl, fr = _one(frames, k, pad=1000 if k == 39 else 0)
            out = system.process_tick(float(ticks[k]), fl, fr,
                                      do_mapping=k % 5 == 4)
            if k == 29:
                assert "sgm_points" in out
            if k == 14:
                kept = [(t, t.clone()) for t in (
                    *vars(system.history).values(),
                    *vars(system.grid).values())]
                corr = np.eye(4)
                corr[:3, 3] = [0.05, -0.02, 0.01]
                system.apply_world_correction(corr)
        counters = prof.take()["counters"]
    finally:
        prof.disable()
        prof.take()
    return system, log, counters, kept


def test_live_cycle_replays_equal_its_stages(smoke, live):
    """Every WORKING cycle of the live path (before and after a world
    correction, after a degrade and re-bootstrap, at two frame
    capacities) is one replay whose window, grid, map points, occupancy
    and counters are the stages' own bits; a replay launches no K2
    eagerly and counts the graph's K2 launches as replayed (a capture
    counts only its warm-up's); each capacity captures its graph once
    (none re-captured in turns); the tracer counts a replay for every
    cycle."""
    system, log, counters, _ = live
    assert system.status.value == "WORKING"
    assert [r["cap"] for r in log] == [8000] * 5 + [9000, 8000]
    assert [r["captured"] for r in log] == [1, 0, 0, 0, 0, 1, 0]
    for r in log:
        assert all(r["same"].values()), r
        assert r["estimates"] > 0 and r["k2_replayed"] >= 1, r
        assert r["k2_launches"] == (r["k2_replayed"] if r["captured"]
                                    else 0), r
    assert len(system.cycle._static) == 2
    assert counters["cycle.replays"] == len(log)
    # the ticks' own graphs count too: one a body and event capacity
    assert counters["graph.captures"] == 2 + len(system._ticks)
    assert "cycle.eager" not in counters


def test_live_cycle_publishes_copies(smoke, live):
    """Tensors taken from system.history and system.grid on tick 14 read
    the same after six more mapping ticks (the tick driver of the
    benchmark keeps references); no two REF_HISTORY maps, and no map and
    a buffer that a graph writes, share storage."""
    system, _, _, kept = live
    assert all(_same_bits(t, copy) for t, copy in kept)
    maps = [{t.untyped_storage().data_ptr() for t in (p, ok)}
            for p, ok, _ in system._ref_maps]
    assert len(maps) >= 4
    assert len(set().union(*maps)) == sum(map(len, maps))
    static = {b.data.untyped_storage().data_ptr()
              for st in system.cycle._static.values()
              for b in (st.window, st.out, st.map)}
    assert not set().union(*maps) & static


def test_live_cycle_capture_error_raises(smoke, live):
    """A cycle that syncs the host cannot be captured: the capture
    raises, no graph is kept and the window is not advanced; the next
    cycle with the real body captures and runs."""
    system, _, _, _ = live
    system.reconfigure(system.cfg, reset=False)     # a cycle with no graph
    cycle = system.cycle
    real_body = cycle._cycle_body

    def body_with_host_sync(*args):
        out = real_body(*args)
        int(out[1][-1].sum())           # the counters to the host
        return out

    scene, ticks, frames = smoke.make_stream("rpg", smoke.make_rig(
        "rpg", "cuda"), n_ticks=10)
    s_l, s_r = cycle.render_pair(system.ts_state_left,
                                 system.ts_state_right, float(ticks[-1]))
    args = (s_l, s_r, _one(frames, 9)[0], *system._pose_arrays(),
            system.T_world_cur)
    hist, slot = cycle.history, cycle.hist_slot
    cycle._cycle_body = body_with_host_sync
    with pytest.raises(RuntimeError):
        cycle.working_cycle(*args)
    torch.cuda.synchronize()
    assert [st.graph for st in cycle._static.values()] == [None]
    assert cycle.history is hist and cycle.hist_slot == slot
    del cycle._cycle_body
    cycle.working_cycle(*args)
    assert [st.graph is not None for st in cycle._static.values()] == [True]
    assert cycle.hist_slot == (slot + 1) % cycle.F


# -- the live tick's body as one CUDA graph ---------------------------------

def _plain_ticks(system):
    """The system with its ticks' bodies on the plain stages, eager on
    the card (``_tick_plain`` in ``_tick_static``'s place)."""
    system._tick_static = system._tick_plain
    return system


def _same_tick(a: dict, b: dict, got, want) -> dict:
    """Which parts of two systems' tick agree bit for bit: both surfaces,
    both kept surface states, the pose after the guard, the per-round rms
    and the point count (and the out keys)."""
    arr = lambda out, key: np.asarray(out.get(key, np.zeros(0)))
    return dict(
        keys=set(a) == set(b),
        surfaces=all(_same_bits(a[k], b[k]) for k in ("ts_left",
                                                      "ts_right")),
        states=all(_same_bits(x, y) for x, y in zip(
            (*vars(got.ts_state_left).values(),
             *vars(got.ts_state_right).values()),
            (*vars(want.ts_state_left).values(),
             *vars(want.ts_state_right).values()))),
        pose=np.array_equal(got.T_world_cur, want.T_world_cur),
        rms=np.array_equal(arr(a, "tracking_rms"), arr(b, "tracking_rms")),
        points=a.get("lm_stats") == b.get("lm_stats"))


def _run_live_ticks(smoke, name, rig, n_ticks, known_poses):
    """Two systems on the card fed the same ticks of the `name` stream
    (chip_smoke.make_stream) through process_tick from INITIALIZATION,
    one with the ticks' graphs (the tracer on around its ticks), one on
    the plain stages; without known poses a world correction after tick
    14 and a watchdog reset on tick 30 (a jump back in time). Returns
    (graphed system, eager system, log: a record a tick, the tracer's
    counters over the graphed system's ticks, the tensors of the graphed
    system's states and surfaces of tick 10, each with a copy taken
    then)."""
    from esvo_tpu_torch.utils import profiling as prof
    cfg = smoke.SystemConfig.from_dict(getattr(smoke, name.upper()))
    scene, ticks, frames = smoke.make_stream(name, rig, n_ticks=n_ticks)
    got = smoke.EsvoSystem(rig, cfg, device="cuda")
    want = _plain_ticks(smoke.EsvoSystem(rig, cfg, device="cuda"))
    log, kept = [], None
    prof.disable()
    prof.take()
    for k in range(n_ticks):
        t = float(ticks[2] if k == 30 and not known_poses else ticks[k])
        gt = smoke.interpolate_gt_pose(scene, t) if known_poses else None
        fl, fr = _one(frames, k)
        graphs = len(got._ticks)
        rec = dict(k=k, t=t, T_cur=got.T_world_cur.copy(),
                   status=got.status.value)
        prof.enable()
        try:
            a = got.process_tick(t, fl, fr, gt_pose=gt,
                                 do_mapping=k % 5 == 4)
        finally:
            prof.disable()
        b = want.process_tick(t, fl, fr, gt_pose=gt, do_mapping=k % 5 == 4)
        rec.update(new_body=len(got._ticks) - graphs,
                   tracked="lm_stats" in a, mapped="map_estimates" in a,
                   same=_same_tick(a, b, got, want))
        log.append(rec)
        if k == 10:
            kept = [(x, x.clone()) for x in (
                *vars(got.ts_state_left).values(),
                *vars(got.ts_state_right).values(), a["ts_left"],
                a["ts_right"])]
        if k == 12:
            assert all(_same_bits(x, copy) for x, copy in kept)
        if k == 14 and not known_poses:
            corr = np.eye(4)
            corr[:3, 3] = [0.05, -0.02, 0.01]
            for sy in (got, want):
                sy.apply_world_correction(corr)
    counters = prof.take()["counters"]
    return got, want, log, counters, kept


@pytest.fixture(scope="module")
def live_ticks(smoke, rig):
    """The rpg closed loop through process_tick, graphed against eager
    (``_run_live_ticks``)."""
    return _run_live_ticks(smoke, "rpg", rig, LIVE_TICKS, False)


@pytest.fixture(scope="module")
def dsec_known_pose_ticks(smoke, dsec_rig):
    """DSEC's known-pose run (the mapper, the tracker bypassed) through
    process_tick, graphed against eager (``_run_live_ticks``)."""
    return _run_live_ticks(smoke, "dsec", dsec_rig,
                           smoke.SCENES["dsec"]["ticks"], True)


def test_live_ticks_replay_equal_the_eager_ticks(smoke, live_ticks):
    """Every live rpg tick (the bootstrap's render-only ticks, tracked
    ticks, mapping ticks, ticks after a world correction and after a
    watchdog reset) is one graph replay whose surfaces, kept states,
    pose, rms and point count are the eager stages' bits; each body
    captures once, on its first tick, and graph.captures counts the
    ticks' graphs and the cycle's; every tick counts a replay, none an
    eager tick."""
    got, want, log, counters, _ = live_ticks
    for rec in log:
        assert all(rec["same"].values()), rec
    assert got.reset_count == want.reset_count == 2
    assert got.status.value == "WORKING"
    statuses = [r["status"] for r in log]
    assert statuses[30] == "WORKING" and statuses[31] == "INITIALIZATION"
    assert sum(r["tracked"] for r in log) >= 25
    assert sum(r["mapped"] for r in log) >= 5
    # a tracked body and a render-only body, one event capacity
    assert sorted(key[1] is not None for key in got._ticks) == [False, True]
    assert all(st.graph is not None for st in got._ticks.values())
    assert [r["k"] for r in log if r["new_body"]] == [0, 5]
    assert counters["tick.replays"] == len(log)
    assert "tick.eager" not in counters
    assert counters["graph.captures"] == len(got._ticks) + len(
        got.cycle._static)


def test_live_ticks_bake_in_no_host_value(smoke, live_ticks):
    """Replays of one graph on ticks of other tick times and other poses
    give the eager results: nothing host-side is frozen into a capture
    (the tick time, the two poses, the events are inputs refilled each
    tick)."""
    got, _, log, _, _ = live_ticks
    replays = [r for r in log if r["tracked"] and not r["new_body"]]
    assert len({r["t"] for r in replays}) == len(replays) >= 20
    assert len({r["T_cur"].tobytes() for r in replays}) >= 20
    assert all(r["same"]["pose"] and r["same"]["surfaces"]
               for r in replays)


def test_live_ticks_publish_copies(smoke, live_ticks):
    """Tensors taken from the surface states and out["ts_left"] /
    out["ts_right"] on tick 10 read the same after every later tick;
    no published state shares storage with a buffer a graph writes."""
    got, _, _, _, kept = live_ticks
    assert all(_same_bits(x, copy) for x, copy in kept)
    static = {b.data.untyped_storage().data_ptr()
              for st in got._ticks.values()
              for b in (st.inputs, st.state, st.sel, st.out) if b is not None}
    published = {x.untyped_storage().data_ptr() for x in (
        *vars(got.ts_state_left).values(),
        *vars(got.ts_state_right).values(), *(x for x, _ in kept))}
    assert not static & published


def test_known_pose_ticks_replay_equal_the_eager_ticks(
        smoke, dsec_known_pose_ticks):
    """DSEC's known-pose ticks (the render-only body at 640x480 and
    40,000 events a camera, over the bootstrap and two WORKING cycles)
    are replays bit for bit the eager stages; one capture, a replay a
    tick, no eager tick."""
    got, _, log, counters, kept = dsec_known_pose_ticks
    for rec in log:
        assert all(rec["same"].values()), rec
    assert got.status.value == "WORKING"
    assert [r["k"] for r in log if r["mapped"]] == [9, 14]
    assert not any(r["tracked"] for r in log)
    assert [key[1] for key in got._ticks] == [None]
    assert counters["tick.replays"] == len(log)
    assert "tick.eager" not in counters
    assert all(_same_bits(x, copy) for x, copy in kept)


# -- the backend and the event simulator (chip_smoke.py's cases) ------------

@pytest.mark.parametrize("case", range(4), ids=[
    "ts_descriptor", "verify_loop_icp", "bundle_adjust",
    "optimize_pose_graph"])
def test_backend_function_card_vs_cpu(smoke, case):
    """The descriptor (1e-5), the ICP verification (accept flag equal, T
    within 1e-4 m / rad), BA (costs non-increasing, poses within 1e-4)
    and the pose graph (1e-4) on the card against the CPU port."""
    name, run, compare = smoke.backend_cases()[case]
    ok, nums = compare(run("cuda"), run("cpu"))
    assert ok, (name, nums)


def test_esim_chunk_card_vs_cpu(smoke):
    """One chunk of substeps of the noise-free sensor on the room scene:
    the events of the card and of the CPU port agree (>= 99.5%, counts
    within 0.5%)."""
    c = smoke.CAMPAIGN
    scene = smoke.esim.make_room_scene(np.random.default_rng(c["seed"]))
    cfg = smoke.esim.SensorConfig(contrast_threshold=c["contrast"],
                                  threshold_fpn_sigma=0.0,
                                  background_rate_hz=0.0, num_hot_pixels=0,
                                  event_budget_per_step=c["budget"])
    pose = smoke.campaign_poses()["left"]
    evs = [smoke.esim.simulate_camera(
        scene, smoke.campaign_K(), c["width"], c["height"], pose, 0.0,
        0.064, cfg, np.random.default_rng(1), device=dev)[0]
        for dev in ("cuda", "cpu")]
    assert abs(len(evs[0]) - len(evs[1])) <= 0.005 * len(evs[1])
    assert smoke.event_match_share(*evs) >= 0.995


@pytest.mark.parametrize("case", [2, 3], ids=["bundle_adjust",
                                              "optimize_pose_graph"])
def test_backend_repeats_itself_on_the_card(smoke, case):
    """BA and the pose graph give the same bits on a second run on the
    card: their segment sums add in one fixed order."""
    _, run, _ = smoke.backend_cases()[case]
    first, second = (smoke._host_arrays(run("cuda")) for _ in range(2))
    assert len(first) == len(second) > 0
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


def test_segment_sum_repeats_itself_on_the_card(smoke):
    """ops.linalg.segment_sum on a CUDA tensor: 200,000 float32 rows into
    64 with many duplicates, the same bits on every call, within 1e-3
    relative of the CPU's sum."""
    from esvo_tpu_torch.ops.linalg import segment_sum
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 64, (200_000,), generator=g)
    vals = torch.randn(200_000, 6, 6, generator=g)
    outs = [segment_sum(vals.cuda(), idx.cuda(), 64).cpu() for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    ref = segment_sum(vals.double(), idx, 64)
    torch.testing.assert_close(outs[0].double(), ref, rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def world1(smoke):
    from esvo_tpu_torch.parallel import sharding as ps
    worlds = smoke.shard_worlds()
    cases = ("surface", "map_rpg", "map_dsec")
    got = ps.run_ranks(smoke.shard_some, 1, worlds, cases, device="cuda")
    return worlds, got


@pytest.mark.parametrize("case", ["surface", "map_rpg", "map_dsec"])
def test_sharded_world1_nccl_is_bitwise(smoke, world1, case):
    worlds, got = world1
    fn, world = smoke.SHARD_CASES[case]
    want = smoke._host_arrays(fn(worlds[world], "cuda"))
    assert smoke._bitwise(smoke._host_arrays(got[case]), want), \
        smoke._max_diff(smoke._host_arrays(got[case]), want)


# --- the port-only kernels: K4 (the tracker's LM scan), K5 (regularization)

@pytest.mark.parametrize("shape", ["rpg", "dsec"])
def test_track_kernel_against_twin(smoke, shape):
    """K4 against solve_plain on the card at the shape's surface, 2000
    map points: pose within 1e-4 m and 1e-4 rad (check_track raises
    otherwise), and it ran as one launch."""
    rig = smoke.make_rig(shape, "cuda")
    before = smoke.track.KERNEL.launches
    res = smoke.check_track(rig, iters=3)
    assert res["t_diff_m"] < 1e-4 and res["R_diff_rad"] < 1e-4
    assert smoke.track.KERNEL.launches > before


@pytest.mark.parametrize("m", [1, 299, 2001])
def test_track_kernel_repeat_launch_is_bitwise(smoke, rig, m):
    """Two K4 launches on the same inputs give the same bits (its sums
    add in one fixed order), and the pose agrees with the twin's."""
    prob, cam, cfg = smoke.track_world(rig, m, seed=3)
    a = smoke.reg.solve(prob, cam, cfg)
    b = smoke.reg.solve(prob, cam, cfg)
    assert all(torch.equal(x, y) for x, y in zip((a[0].R, a[0].t, a[1], a[2]),
                                                 (b[0].R, b[0].t, b[1], b[2])))
    t_diff, R_diff = smoke._pose_diff(a[1], smoke.reg.solve_plain(
        prob, cam, cfg)[1])
    assert t_diff < 1e-4 and R_diff < 1e-4


def test_cuda_tensor_never_takes_the_k4_k5_twins(smoke, rig, monkeypatch):
    """On CUDA tensors solve and regularize launch K4 / K5; the twins are
    never called, and a dtype the kernel does not take raises."""
    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached a twin")

    prob, cam, cfg = smoke.track_world(rig, 300, seed=4)
    grid = smoke.regularize_world(180, 240, seed=4)
    rcfg = smoke.SystemConfig.from_dict(smoke.RPG).regularizer
    monkeypatch.setattr(smoke.reg, "solve_plain", refuse)
    import esvo_tpu_torch.mapping.regularization as mreg
    monkeypatch.setattr(mreg, "regularize_plain", refuse)
    before = (smoke.track.KERNEL.launches,
              smoke.regularize_op.KERNEL.launches)
    smoke.reg.solve(prob, cam, cfg)
    mreg.regularize(grid, rcfg)
    assert (smoke.track.KERNEL.launches,
            smoke.regularize_op.KERNEL.launches) == (before[0] + 1,
                                                     before[1] + 1)
    with pytest.raises(TypeError):
        mreg.regularize(grid.replace(variance=grid.variance.double()), rcfg)
    with pytest.raises(TypeError):
        smoke.track.track_solve(
            prob.R.double(), prob.t, prob.T_world_ref, prob.points,
            prob.point_valid, prob.ts_negative, prob.grad_u, prob.grad_v,
            cam.params.P, cam.mask, batch_size=300, max_iteration=10,
            huber=True, huber_threshold=50.0, lm_damping=1e-3)


@pytest.mark.parametrize("shape", ["rpg", "dsec"])
def test_regularize_kernel_is_bitwise(smoke, shape):
    """K5 equals regularize_plain bit for bit on the card at the preset's
    radius (5 at rpg, 20 at DSEC) in both norms (check_regularize raises
    otherwise)."""
    preset = smoke.RPG if shape == "rpg" else smoke.DSEC
    rcfg = smoke.SystemConfig.from_dict(preset).regularizer
    H, W = (180, 240) if shape == "rpg" else (480, 640)
    res = smoke.check_regularize(H, W, rcfg, iters=3)
    assert res["max_abs_err"] == 0.0 and res["radius"] in (5, 20)
    for norm in ("Tdist", "l2"):
        assert 0 < res["by_norm"][norm]["kept"] < res["valid"]


@pytest.mark.parametrize("n_valid", [600, 1])
@pytest.mark.parametrize("shape", ["rpg", "dsec"])
def test_track_kernel_empty_batches(smoke, shape, n_valid):
    """K4 on a map of n_valid points in 2000 slots (600: 6 of 10 rounds
    find no valid point; 1: 8): two launches bit for bit, rms 0 on the
    empty rounds (which K4 skips) and the pose within 1e-4 m and 1e-4
    rad of solve_plain's, which runs every round."""
    rig = smoke.make_rig(shape, "cuda")
    prob, cam, cfg = smoke.track_world(rig, 2000, seed=3, n_valid=n_valid)
    before = smoke.track.KERNEL.launches
    a = smoke.reg.solve(prob, cam, cfg)
    b = smoke.reg.solve(prob, cam, cfg)
    assert smoke.track.KERNEL.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip((a[0].R, a[0].t, a[1], a[2]),
                                                 (b[0].R, b[0].t, b[1], b[2])))
    want = smoke.reg.solve_plain(prob, cam, cfg)
    B, nb = cfg.batch_size, 2000 // cfg.batch_size
    empty = [min((it % nb) * B, 2000 - B) >= n_valid
             for it in range(cfg.max_iteration)]
    assert sum(empty) == (6 if n_valid == 600 else 8)
    rms = a[2].cpu().numpy()
    assert (rms[np.array(empty)] == 0.0).all()
    assert (want[2].cpu().numpy()[np.array(empty)] == 0.0).all()
    t_diff, R_diff = smoke._pose_diff(a[1], want[1])
    assert t_diff < 1e-4 and R_diff < 1e-4


@pytest.mark.parametrize("norm", ["Tdist", "l2"])
@pytest.mark.parametrize("pattern", ["random", "empty", "full", "corners",
                                     "edges"])
@pytest.mark.parametrize("shape", ["rpg", "dsec"])
def test_regularize_kernel_occupancy_patterns(smoke, shape, pattern, norm):
    """K5 equals regularize_plain bit for bit (NaN matching NaN) at the
    preset's radius and gates on each occupancy pattern of
    chip_smoke.regularize_world (the corners with gates of 0), in both
    norms, as one launch a call; two launches agree."""
    import dataclasses as dc
    import esvo_tpu_torch.mapping.regularization as mreg
    preset = smoke.RPG if shape == "rpg" else smoke.DSEC
    rcfg = dc.replace(smoke.SystemConfig.from_dict(preset).regularizer,
                      ls_norm=norm)
    if pattern == "corners":
        rcfg = dc.replace(rcfg, min_neighbours=0, min_close_neighbours=0)
    H, W = (180, 240) if shape == "rpg" else (480, 640)
    grid = smoke.regularize_world(H, W, seed=9, pattern=pattern)
    before = smoke.regularize_op.KERNEL.launches
    got = mreg.regularize(grid, rcfg).inv_depth
    again = mreg.regularize(grid, rcfg).inv_depth
    assert smoke.regularize_op.KERNEL.launches == before + 2
    want = mreg.regularize_plain(grid, rcfg).inv_depth
    assert smoke._same_bits(got, want) and smoke._same_bits(got, again)
    if pattern == "edges":
        assert torch.isnan(want).any()


def test_regularize_layout_matches_the_kernel(smoke):
    """ops/regularize.py's shared-memory layout is the kernel's, at the
    preset radii and the largest the dispatch takes (45)."""
    for r in (5, 20, 45):
        info = smoke.regularize_op.kernel_info(True, r)
        assert info["smem_bytes"] == smoke.regularize_op.shared_bytes(r)
        assert info["blocks_per_sm"] >= 1 and info["local_bytes"] == 0


def test_resident_replay_launches_k4_once_a_tick(smoke, resident):
    """One graph replay of a roll launches K4 once a tracked tick and K5
    once (the roll's mapping cycle), counted by kernel name."""
    system, loop, roll = resident
    snap = loop.state.map(torch.clone)
    loop.stage(*roll)
    loop.step()                         # captures on the first call
    loop.state.copy_(snap)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        loop.step()
        torch.cuda.synchronize()
    loop.state.copy_(snap)
    dev = [e for e in prof.key_averages()
           if e.device_type == smoke.DeviceType.CUDA]
    counts = smoke.kernel_counts(dev)
    assert counts["track"] == smoke.ROLL
    assert counts["regularize"] == 1
    assert counts["bm"] == 1 and counts["fuse"] == 1


def test_float64_grid_regularizes_through_the_twin(smoke):
    """A float64 grid on the card goes to regularize_plain (K5 takes
    float32 only): no K5 launch, and the same inverse depths as
    regularize_plain on the CPU (float64 elementwise: bit for bit)."""
    import dataclasses as dc
    import esvo_tpu_torch.mapping.regularization as mreg
    rcfg = smoke.SystemConfig.from_dict(smoke.RPG).regularizer
    grid = smoke.regularize_world(180, 240, seed=5)
    g64 = grid.replace(**{f.name: getattr(grid, f.name).double()
                          for f in dc.fields(grid)
                          if getattr(grid, f.name).is_floating_point()})
    before = smoke.regularize_op.KERNEL.launches
    got = mreg.regularize(g64, rcfg).inv_depth
    assert smoke.regularize_op.KERNEL.launches == before
    want = mreg.regularize_plain(smoke._tree(g64, lambda a: a.cpu()),
                                 rcfg).inv_depth
    assert got.dtype == torch.float64 and torch.equal(got.cpu(), want)


# --- K6 (block matching's disparity scan) and K7 (the fusion fold)

_SHAPES = {"rpg": (1000, 8), "dsec": (10000, 40)}


@pytest.mark.parametrize("shape", ["rpg", "dsec"])
def test_block_match_kernel_is_bitwise(smoke, shape):
    """K6 equals best_disparity_plain bit for bit on every event at the
    preset's patch, range and smoothing, and match_events_stats'
    validity, costs and counters equal the twin's (check_block_match
    raises otherwise)."""
    rig = smoke.make_rig(shape, "cuda")
    cfg = smoke.SystemConfig.from_dict(smoke.RPG if shape == "rpg"
                                       else smoke.DSEC)
    n, disp = _SHAPES[shape]
    res = smoke.check_block_match(rig, cfg, n, disp, iters=3)
    assert res["bitwise"] and res["match_equal"] and res["nan_bitwise"]
    assert all(p["bitwise"] for p in res["other_patches"].values())
    assert res["matched"] > 0.3 * n


@pytest.mark.parametrize("shape", ["rpg", "dsec"])
def test_fuse_kernel_is_bitwise(smoke, shape):
    """K7 equals fold_slots_plain bit for bit in all 11 planes, with the
    same fuse and drop counts, at fusion radius 0 and 1 in Tdist and l2
    (check_fuse raises otherwise)."""
    rig = smoke.make_rig(shape, "cuda")
    cfg = smoke.SystemConfig.from_dict(smoke.RPG if shape == "rpg"
                                       else smoke.DSEC)
    res = smoke.check_fuse(rig, cfg, 4 * _SHAPES[shape][0], iters=3)
    assert all(not c["differ"] for c in res["by_case"].values())
    assert all(c["dropped"] > 0 for c in res["by_case"].values())


def test_k6_k7_repeat_launch_is_bitwise(smoke, rig):
    """Two launches of each kernel on the same inputs give the same
    bits."""
    ts_l, ts_r, x, _ = smoke.bm_world(rig, 2000, 8, seed=4)
    ui = torch.clamp(torch.floor(x[:, 0]).long(), 0, 239)
    vi = torch.clamp(torch.floor(x[:, 1]).long(), 0, 179)
    kw = dict(dmin=1, dmax=40, hy=3, hx=7)
    a = smoke.block_match_op.best_disparity(ts_l, ts_r, ui, vi, **kw)
    b = smoke.block_match_op.best_disparity(ts_l, ts_r, ui, vi, **kw)
    assert all(smoke._same_bits(p, q) for p, q in zip(a, b))
    grid, cand = smoke.fuse_world(180, 240, 4000, seed=4)
    cfg = smoke.fu.FusionConfig(fusion_radius=1)
    g1, n1, d1 = smoke.fu.fuse_frame(grid, cand, rig.left, cfg)
    g2, n2, d2 = smoke.fu.fuse_frame(grid, cand, rig.left, cfg)
    assert int(n1) == int(n2) > 0 and int(d1) == int(d2)
    assert all(smoke._same_bits(getattr(g1, f), getattr(g2, f))
               for f in ("inv_depth", "variance", "scale2", "nu",
                         "residual", "age", "x", "p_cam"))


def test_cuda_tensor_never_takes_the_k6_k7_twins(smoke, rig, monkeypatch):
    """On CUDA float32 tensors match_events_stats ("auto" and "slice")
    launches K6 once a call and fuse_frame K7 once a call; the twins are
    never called, nor the rank placement (_assign_slots, _segment_rank)."""
    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached a twin")

    ts_l, ts_r, x, valid = smoke.bm_world(rig, 1000, 8, seed=5)
    grid, cand = smoke.fuse_world(180, 240, 4000, seed=5)
    monkeypatch.setattr(smoke.bm, "best_disparity_plain", refuse)
    for name in ("fold_slots_plain", "_assign_slots", "_segment_rank",
                 "run_bounds"):
        monkeypatch.setattr(smoke.fu, name, refuse)
    args = (ts_l, ts_r, x, x, torch.zeros(1000, device="cuda"), valid,
            rig.left.mask, rig)
    before = (smoke.block_match_op.KERNEL.launches,
              smoke.fuse_op.KERNEL.launches)
    for strategy in ("auto", "slice"):
        smoke.bm.match_events_stats(*args, smoke.bm.BlockMatchConfig(
            cost_strategy=strategy))
    smoke.fu.fuse_frame(grid, cand, rig.left, smoke.fu.FusionConfig())
    assert (smoke.block_match_op.KERNEL.launches,
            smoke.fuse_op.KERNEL.launches) == (before[0] + 2, before[1] + 1)


@pytest.mark.parametrize("wy, wx, dmin, dmax", [
    (7, 15, 1, 20), (7, 15, 1, 40), (7, 15, 0, 70), (7, 15, 0, 100),
    (7, 15, 0, 150), (7, 15, 0, 300), (15, 7, 1, 40), (15, 7, 0, 150),
    (5, 9, 1, 40), (3, 3, 0, 200)],
    ids=["7x15-T1", "7x15-T2", "7x15-T3", "7x15-T4", "7x15-T5",
         "7x15-2passes", "15x7-T2", "15x7-T5", "generic-5x9",
         "generic-3x3"])
def test_block_match_instantiations_are_bitwise(smoke, rig, wy, wx, dmin,
                                                dmax):
    """Each K6 instantiation the launch plan picks equals
    best_disparity_plain bit for bit on bm_world's events (windows
    clamped at every border), with NaNs in the right surface."""
    ts_l, ts_r, x, _ = smoke.bm_world(rig, 600, 8, seed=wy * wx + dmax)
    ts_r[::19, ::29] = float("nan")
    ui = torch.clamp(torch.floor(x[:, 0]).long(), 0, 239)
    vi = torch.clamp(torch.floor(x[:, 1]).long(), 0, 179)
    kw = dict(dmin=dmin, dmax=dmax, hy=(wy - 1) // 2, hx=(wx - 1) // 2)
    got = smoke.block_match_op.best_disparity(ts_l, ts_r, ui, vi, **kw)
    want = smoke.bm.best_disparity_plain(ts_l, ts_r, ui, vi, dmin, dmax,
                                         kw["hy"], kw["hx"], "slice")
    assert all(smoke._same_bits(p, q) for p, q in zip(got, want))
    assert bool(torch.isnan(got[1]).any()) and bool((got[1] < 1).any())


@pytest.mark.parametrize("wy, wx, n_disp", [
    (7, 15, 40), (7, 15, 151), (15, 7, 151), (5, 9, 40)])
def test_block_match_plan_on_the_card(smoke, wy, wx, n_disp):
    """The plan's instantiation exists, spills nothing and fits an SM at
    the plan's events a block."""
    info = smoke.block_match_op.kernel_info(wy, wx, n_disp)
    plan = smoke.block_match_op.launch_plan(wy, wx, n_disp)
    assert info["instantiation"] == plan["instantiation"]
    assert info["smem_bytes"] == plan["shared_bytes"] <= 48 * 1024
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1


@pytest.mark.parametrize("radius", [0, 1])
def test_fuse_drop_count_equals_the_rank(smoke, rig, radius):
    """K7's num_dropped equals _assign_slots' and run_bounds' on the card
    (pixels with more than K candidates), and run_bounds equals itself
    on the CPU."""
    grid, cand = smoke.fuse_world(180, 240, 4000, seed=8 + radius)
    cfg = smoke.fu.FusionConfig(fusion_radius=radius)
    _, _, dropped = smoke.fu.fuse_frame(grid, cand, rig.left, cfg)
    tiled, pix = smoke.fu._splat(cand, 180, 240, radius)
    _, want = smoke.fu._assign_slots(pix, tiled.valid, tiled.variance,
                                     180 * 240, 8)
    order, ps = smoke.fu._sort_slots(pix, tiled.valid, tiled.variance,
                                     180 * 240)
    start, end, nd = smoke.fu.run_bounds(ps, 180 * 240, 8)
    cs, ce, cnd = smoke.fu.run_bounds(ps.cpu(), 180 * 240, 8)
    assert int(dropped) == int(want) == int(nd) == int(cnd) > 0
    assert torch.equal(start.cpu(), cs) and torch.equal(end.cpu(), ce)


def test_fuse_long_stretch_is_bitwise(smoke, rig):
    """A block whose stretch of the sorted order outgrows K7's shared
    buffer searches it in L2: 3,000 candidates x 9 tiles on a 16x16 grid,
    bit for bit the twin with its fuse and drop counts."""
    grid, cand = smoke.fuse_world(16, 16, 3000, seed=34)
    cfg = smoke.fu.FusionConfig(fusion_radius=1)
    got, nf, nd = smoke.fu.fuse_frame(grid, cand, rig.left, cfg)
    tiled, pix = smoke.fu._splat(cand, 16, 16, 1)
    slot, want_nd = smoke.fu._assign_slots(pix, tiled.valid, tiled.variance,
                                           256, 8)
    want, want_nf = smoke.fu.fold_slots_plain(grid, tiled, slot, rig.left,
                                              cfg)
    assert int(nf) == int(want_nf) and int(nd) == int(want_nd) > 2048
    assert all(smoke._same_bits(getattr(got, f), getattr(want, f))
               for f in ("inv_depth", "variance", "scale2", "nu",
                         "residual", "age", "x", "p_cam"))
