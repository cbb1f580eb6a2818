"""Kernel K6 (block matching's disparity scan), its dispatch and its
plain twin (mapping/block_matching.py).

- ``best_disparity_plain`` (what the CPU runs) against JAX's
  ``_match_horizontal`` on the world of tests/test_block_matching.py in
  float32: the DSEC preset's 151 disparities from 0, ``up_down`` and
  ``step = 2`` with the local-minimum check. As in
  tests/test_torch_block_matching.py: validity on >= 99% of the events,
  disparity and inverse depth equal on >= 99% of those matched on both
  sides, cost atol 1e-5, the failure counters equal.
- K6's order of operations: a numpy float32 reference that adds, one
  operation at a time, in the order csrc/block_match.cu adds (column sums
  from the top row down, then the columns left to right; the left
  window's sums at the event; a masked disparity costs 1.0; torch's
  argmin, a NaN first) equals the twin bit for bit on events whose
  windows are clamped at every border, and on a surface with a NaN. On
  the CPU a division by the patch area is a true division; the kernel
  multiplies by the float32 reciprocal, as PyTorch's CUDA division by a
  Python scalar does (the card checks hold it to the twin there).
- The dispatch rule (``kernel_takes``): CPU tensors, float64 and the
  "matmul" volume take the twin; the wrapper's checks raise on a wrong
  dtype, shape or a strip too wide for a block, and a CPU tensor never
  launches.
- The launch plan (``block_match.launch_plan``): the 7x15 and 15x7
  instantiations with T = ceil(D / 32) disparities a lane within 2..5
  (more passes past 160), the generic one for any other patch, and as
  many events a block as fit 48 KB.
The kernel itself runs on the card only (tests/test_torch_cuda.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.geometry.camera import make_ideal_rig
from esvo_tpu.mapping import block_matching as jbm
from esvo_tpu_torch import convert
from esvo_tpu_torch.mapping import block_matching as tbm
from esvo_tpu_torch.ops import block_match

W, H = 240, 180
FX = 200.0
BASELINE = 0.1
f32 = np.float32


def _rigs():
    rj = make_ideal_rig(W, H, FX, FX, W / 2 - 0.5, H / 2 - 0.5, BASELINE,
                        dtype=jnp.float32)
    return rj, convert.rig_from_numpy(convert.rig_to_numpy(rj), device="cpu")


def _shifted_pair(rng, disp, vertical=False, h=H, w=W):
    """tests/test_block_matching.py's shifted_pair (and its vertical
    twin): a horizontally smoothed random texture and its shift."""
    n = (h + 64, w) if vertical else (h, w + 64)
    base = rng.uniform(0, 255, size=n)
    k = np.ones(5) / 5
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"),
                               0 if vertical else 1, base)
    if vertical:
        return base[32:32 + h], base[32 + disp:32 + disp + h]
    return base[:, 32:32 + w], base[:, 32 + disp:32 + disp + w]


@pytest.fixture
def twin_only(monkeypatch):
    """Fail if anything reaches K6's wrapper (CPU tensors run the twin)."""
    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached K6's wrapper")
    monkeypatch.setattr(block_match, "best_disparity", refuse)


def _assert_agree(x, valid, ts_l, ts_r, **cfg):
    rj, rt = _rigs()
    N = x.shape[0]
    a, sa = jbm.match_events_stats(
        jnp.asarray(ts_l, f32), jnp.asarray(ts_r, f32), jnp.asarray(x, f32),
        jnp.asarray(x, f32), jnp.zeros(N, f32), jnp.asarray(valid),
        rj.left.mask, rj, jbm.BlockMatchConfig(cost_strategy="slice", **cfg))
    b, sb = tbm.match_events_stats(
        torch.tensor(ts_l, dtype=torch.float32),
        torch.tensor(ts_r, dtype=torch.float32),
        torch.tensor(x, dtype=torch.float32),
        torch.tensor(x, dtype=torch.float32), torch.zeros(N),
        torch.tensor(valid), rt.left.mask, rt, tbm.BlockMatchConfig(**cfg))
    va, vb = np.asarray(a.valid), b.valid.numpy()
    assert (va == vb).mean() >= 0.99
    both = va & vb
    for name in ("disparity", "inv_depth"):
        eq = (np.asarray(getattr(a, name))[both]
              == getattr(b, name).numpy()[both])
        assert eq.size == 0 or eq.mean() >= 0.99, name
    np.testing.assert_allclose(b.cost.numpy()[both], np.asarray(a.cost)[both],
                               atol=1e-5)
    assert {k: int(v) for k, v in sb.items()} == \
        {k: int(v) for k, v in sa.items()}
    return va, sb


def test_twin_matches_jax_at_dsec_disparities(twin_only):
    """151 disparities from 0 (the DSEC preset's range) on a 9-pixel
    shift."""
    rng = np.random.default_rng(9)
    ts_l, ts_r = _shifted_pair(rng, 9)
    N = 200
    x = np.stack([rng.uniform(0, W, N), rng.uniform(0, H, N)], axis=1)
    va, _ = _assert_agree(x, rng.random(N) > 0.05, ts_l, ts_r,
                          min_disparity=0, max_disparity=150)
    assert va.mean() > 0.5


def test_twin_matches_jax_up_down(twin_only):
    rng = np.random.default_rng(2)
    ts_l, ts_r = _shifted_pair(rng, 6, vertical=True)
    N = 100
    x = np.stack([rng.uniform(20, W - 20, N), rng.uniform(40, H - 20, N)],
                 axis=1)
    va, _ = _assert_agree(x, np.ones(N, bool), ts_l, ts_r, up_down=True)
    assert va.mean() > 0.5


def test_twin_matches_jax_step_2_local_minimum(twin_only):
    """A 1-pixel shift with step = 2: the minimum sits at the range's
    boundary, so the local-minimum check rejects most events."""
    rng = np.random.default_rng(4)
    ts_l, ts_r = _shifted_pair(rng, 1)
    N = 200
    x = np.stack([rng.uniform(60, W - 20, N), rng.uniform(10, H - 10, N)],
                 axis=1)
    _, sb = _assert_agree(x, np.ones(N, bool), ts_l, ts_r, step=2)
    assert int(sb["fine_fail"]) > 0.5 * N


# --- K6's order of operations, one float32 operation at a time ----------

def _before(a, ia, b, ib) -> bool:
    """torch.argmin's order (LessOrNan)."""
    if np.isnan(a):
        return ia < ib if np.isnan(b) else True
    if np.isnan(b):
        return False
    return ia < ib if a == b else bool(a < b)


def k6_reference(L, R, ui, vi, dmin, dmax, hy, hx, reciprocal=False):
    """best, best_cost, dark of each event, in csrc/block_match.cu's
    order; `reciprocal` divides by the area as the card's twin does."""
    Hh, Ww = L.shape
    wy, wx = 2 * hy + 1, 2 * hx + 1
    area = f32(wy * wx)
    inv = f32(f32(1.0) / area)
    zero = f32(0.0)

    def div(a):
        return f32(a * inv) if reciprocal else f32(a / area)

    def moments(S, S2):
        m = div(S)
        sigma = f32(np.sqrt(np.maximum(f32(div(S2) - f32(m * m)), zero))
                    + f32(1e-6))
        return m, sigma

    def box(val, y0, x0):
        """_box at one pixel: each column top down from 0 (rows outside
        the image add the zero pad), the columns left to right from 0 (a
        column outside adds the zero pad)."""
        S = zero
        for dx in range(wx):
            x = x0 + dx
            col = zero
            if 0 <= x < Ww:
                for dy in range(wy):
                    y = y0 + dy
                    col = f32(col + (val(y, x) if 0 <= y < Hh else zero))
            S = f32(S + col)
        return S

    out = []
    for u, v in zip(ui.tolist(), vi.tolist()):
        y0 = v - hy
        S_l = box(lambda y, x: L[y, x], y0, u - hx)
        S_l2 = box(lambda y, x: f32(L[y, x] * L[y, x]), y0, u - hx)
        dark = box(lambda y, x: f32(1.0) if L[y, x] < 1 else zero, y0,
                   u - hx)
        m_l, sigma_l = moments(S_l, S_l2)
        bc, bi = f32(np.inf), 1 << 40
        for k, d in enumerate(range(dmin, dmax + 1)):
            cost = f32(1.0)
            if u - d - hx >= 1 and u - d + hx < Ww - 1:
                S_r = box(lambda y, x: R[y, x], y0, u - d - hx)
                S_r2 = box(lambda y, x: f32(R[y, x] * R[y, x]), y0,
                           u - d - hx)
                S_lr = box(lambda y, x, d=d: f32(
                    L[y, x] * (R[y, x - d] if x - d >= 0 else zero)),
                    y0, u - hx)
                m_r, sigma_r = moments(S_r, S_r2)
                ncc = f32(f32(div(S_lr) - f32(m_l * m_r))
                          / f32(sigma_l * sigma_r))
                cost = f32(f32(0.5) * f32(f32(1.0) - ncc))
            if _before(cost, k, bc, bi):
                bc, bi = cost, k
        out.append((bi, bc, dark))
    best, cost, dark = (np.array(c) for c in zip(*out))
    return best.astype(np.int64), cost.astype(f32), dark.astype(f32)


def _order_world(seed, h, w, nan_at=None):
    rng = np.random.default_rng(seed)
    L, R = (a.astype(f32) for a in _shifted_pair(rng, 5, h=h, w=w))
    # dark pixels (below 1) in a band, for the noise count
    L[: h // 3, : w // 4] *= f32(0.004)
    if nan_at is not None:
        R[nan_at] = np.nan
    return L, R


@pytest.mark.parametrize("h, w, dmin, dmax, hy, hx, nan_at", [
    (24, 48, 1, 40, 3, 7, None),
    (16, 200, 0, 150, 3, 7, None),
    (30, 20, 0, 12, 7, 3, None),           # up_down's swapped patch
    (24, 48, 0, 20, 3, 7, (12, 20)),
], ids=["rpg-range", "dsec-range", "swapped-patch", "nan"])
def test_kernel_order_equals_twin_bitwise(h, w, dmin, dmax, hy, hx, nan_at):
    L, R = _order_world(h * w + dmax, h, w, nan_at)
    rng = np.random.default_rng(dmax)
    corners = [(0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1),
               (w // 2, 1), (w // 2, h - 2)]
    inner = [(int(rng.integers(0, w)), int(rng.integers(0, h)))
             for _ in range(6)]
    if nan_at is not None:
        inner += [(nan_at[1] + d, nan_at[0]) for d in (0, 3, 9)]
    ui = np.array([c[0] for c in corners + inner], np.int64)
    vi = np.array([c[1] for c in corners + inner], np.int64)
    want = k6_reference(L, R, ui, vi, dmin, dmax, hy, hx)
    got = tbm.best_disparity_plain(torch.from_numpy(L), torch.from_numpy(R),
                                   torch.from_numpy(ui), torch.from_numpy(vi),
                                   dmin, dmax, hy, hx, "slice")
    for g, wnt, name in zip(got, want, ("best", "best_cost", "dark")):
        np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                      wnt.view(np.uint8), err_msg=name)
    assert (want[1] < 1.0).any() and (want[1] == 1.0).any()
    if nan_at is not None:
        assert np.isnan(want[1]).any()       # a NaN cost won an argmin


# --- the dispatch rule and the wrapper's checks ---------------------------

def test_kernel_takes_the_slice_strategy_in_float32():
    ts = torch.zeros(8, 8)
    assert tbm.kernel_takes(ts, 7, 15, 151, "auto")
    assert tbm.kernel_takes(ts, 7, 15, 40, "slice")
    assert not tbm.kernel_takes(ts, 7, 15, 40, "matmul")
    assert not tbm.kernel_takes(ts.double(), 7, 15, 40, "slice")
    # an event's window (whole float4s), its column sums and the strip's,
    # and the strip, 1,638 words rounded up to whole float4s; a strip
    # wider than a block's 48 KB goes to the twin
    assert 108 + 45 + 2 * 165 + 7 * 165 == 1638
    assert block_match.shared_bytes(7, 15, 151) == 4 * 1640
    assert not tbm.kernel_takes(ts, 15, 15, 1000, "slice")


@pytest.mark.parametrize("strategy", ["auto", "slice", "matmul"])
def test_cpu_and_float64_take_the_twin(strategy, monkeypatch, twin_only):
    """CPU tensors (and float64) never reach the wrapper; "matmul" keeps
    its volume, the other strategies the slice volume."""
    called = []
    for name in ("_volume_slice", "_volume_matmul"):
        fn = getattr(tbm, name)
        monkeypatch.setattr(tbm, name, lambda *a, fn=fn, name=name: (
            called.append(name), fn(*a))[1])
    L, R = (torch.from_numpy(a) for a in _order_world(1, 20, 40))
    ui = torch.tensor([20, 30, 39])
    vi = torch.tensor([5, 10, 19])
    for dtype in (torch.float32, torch.float64):
        tbm.best_disparity(L.to(dtype), R.to(dtype), ui, vi, 0, 12, 3, 7,
                           strategy)
    want = "_volume_matmul" if strategy == "matmul" else "_volume_slice"
    assert called == [want, want]


def _wrapper_args():
    return dict(ts_left=torch.zeros(20, 30), ts_right=torch.zeros(20, 30),
                ui=torch.zeros(5, dtype=torch.int64),
                vi=torch.zeros(5, dtype=torch.int64))


@pytest.mark.parametrize("name, bad, exc", [
    ("ts_left", torch.zeros(20, 30, dtype=torch.float64), TypeError),
    ("ts_right", torch.zeros(20, 31), ValueError),
    ("ui", torch.zeros(5, dtype=torch.int32), TypeError),
    ("vi", torch.zeros(6, dtype=torch.int64), ValueError),
    ("ts_right", torch.zeros(20, 30, device="meta"), ValueError),
], ids=["left-f64", "right-shape", "ui-int32", "vi-length", "device"])
def test_wrapper_checks_raise(name, bad, exc):
    args = _wrapper_args()
    block_match.check_inputs(**args, dmin=0, dmax=150, hy=3, hx=7)
    args[name] = bad
    with pytest.raises(exc):
        block_match.check_inputs(**args, dmin=0, dmax=150, hy=3, hx=7)


def test_wrapper_refuses_a_wide_strip_and_cpu_tensors():
    with pytest.raises(ValueError, match="strip"):
        block_match.check_inputs(**_wrapper_args(), dmin=0, dmax=2000, hy=3,
                                 hx=7)
    with pytest.raises(ValueError, match="disparities"):
        block_match.check_inputs(**_wrapper_args(), dmin=3, dmax=2, hy=3,
                                 hx=7)
    before = block_match.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        block_match.best_disparity(**_wrapper_args(), dmin=0, dmax=40, hy=3,
                                   hx=7)
    assert block_match.KERNEL.launches == before


@pytest.mark.parametrize("wy, wx, n_disp, patch, t, passes, events", [
    (7, 15, 40, "7x15", 2, 1, 4),       # rpg
    (7, 15, 151, "7x15", 5, 1, 4),      # DSEC
    (15, 7, 151, "15x7", 5, 1, 4),      # up_down's swapped patch
    (15, 7, 40, "15x7", 2, 1, 4),
    (7, 15, 20, "7x15", 2, 1, 4),       # at least 2 a lane
    (7, 15, 100, "7x15", 4, 1, 4),
    (7, 15, 300, "7x15", 5, 2, 4),      # a second pass past 160
    (7, 15, 1200, "7x15", 5, 8, 1),     # one event fills a block
    (5, 9, 40, "generic", 1, 2, 4),
    (15, 15, 151, "generic", 1, 5, 3),
    (7, 13, 151, "generic", 1, 5, 4),
], ids=["rpg", "dsec", "swapped-dsec", "swapped-rpg", "small-range",
        "T4", "two-passes", "one-event-a-block", "generic-5x9",
        "generic-15x15", "generic-7x13"])
def test_launch_plan_picks_the_instantiation(wy, wx, n_disp, patch, t,
                                             passes, events):
    plan = block_match.launch_plan(wy, wx, n_disp)
    assert (plan["patch"], plan["T"], plan["passes"],
            plan["events_per_block"]) == (patch, t, passes, events)
    name = (f"block_match_kernel<{wy}, {wx}, {t}>" if patch != "generic"
            else "block_match_kernel<0, 0, 1>")
    assert plan["instantiation"] == name
    assert plan["threads"] == 32 * events
    assert plan["shared_bytes"] == events * block_match.shared_bytes(
        wy, wx, n_disp) <= block_match.MAX_SHARED_BYTES
    # every patch the dispatch rule takes has a plan that launches
    assert tbm.kernel_takes(torch.zeros(4, 4), wy, wx, n_disp, "slice")


@pytest.mark.parametrize("wy, wx, n_disp, lane, warp", [
    (7, 15, 40, 72.0, (45 + 27 + 16 * 9) / 40),      # rpg: T = 2
    (7, 15, 151, 34.2, (45 + 27 + 19 * 9) / 151),    # DSEC: T = 5
    (5, 9, 40, 108, (27 + 2 * 108) / 40),            # generic, 2 passes
], ids=["rpg", "dsec", "generic-5x9"])
def test_shared_loads_counted_from_the_plan(wy, wx, n_disp, lane, warp):
    """chip_smoke.k6_shared_loads: a templated lane reads each of its T +
    wx - 1 strip columns' wy words and 2 column sums once for its T
    pairs; the generic kernel reads 2 words a product and 2 sums a
    column, a pair a lane a pass."""
    import chip_smoke
    got = chip_smoke.k6_shared_loads(wy, wx, n_disp)
    assert got["lane"] == pytest.approx(lane)
    assert got["warp"] == pytest.approx(warp)
