"""The port's temporal event matcher (mapping/event_matcher.py) against the
JAX package's on the same inputs: the five cases of
tests/test_event_matcher.py in float64 (their dtype), and a float32 case
of 200 left events with mixed polarities and a padded right tail.

Tolerances: ``valid`` equal; disparity and inverse depth within rtol 1e-6
where both are valid; cost within 1e-5 absolute; ``window_overflow``
equal. In float32 the ZNCC means sum in another order, so a near-tie
between two candidates may flip: ``valid`` equal on >= 99% of the events
there, and the values agree where both chose the same candidate.
"""
import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.geometry.camera import make_ideal_rig
from esvo_tpu.mapping import event_matcher as jem
from esvo_tpu_torch import convert
from esvo_tpu_torch.mapping import event_matcher as tem

W, H = 128, 96
FX = 100.0
BASELINE = 0.1


def _rigs(dtype):
    jd = jnp.float64 if dtype == np.float64 else jnp.float32
    rig = make_ideal_rig(W, H, FX, FX, W / 2 - 0.5, H / 2 - 0.5, BASELINE,
                         dtype=jd)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    return rig, convert.rig_from_numpy(convert.rig_to_numpy(rig), dtype=tdt,
                                       device="cpu")


def _run_both(ts_l, ts_r, lx, lt, lp, lv, rx, rt, rp, rv, cfg_kw,
              dtype=np.float64):
    """(JAX (matches, stats), port (matches, stats)) on the same inputs."""
    jrig, trig = _rigs(dtype)
    n = len(lt)
    T = np.broadcast_to(np.eye(4, dtype=dtype), (n, 4, 4))
    f = lambda a: np.asarray(a, dtype)
    args = [f(ts_l), f(ts_r), f(lx), f(lt), np.asarray(lp, bool),
            np.asarray(lv, bool), f(T), f(rx), f(rt), np.asarray(rp, bool),
            np.asarray(rv, bool)]
    jcfg = jem.EventMatcherConfig(**cfg_kw)
    out_j = jax.jit(lambda *a: jem.match_events_temporal_stats(
        *a, jrig, jcfg))(*[jnp.asarray(a) for a in args])
    out_t = tem.match_events_temporal_stats(
        *[torch.from_numpy(np.array(a)) for a in args], trig,
        tem.EventMatcherConfig(**cfg_kw))
    return out_j, out_t


def _assert_agree(out_j, out_t, min_valid_share=1.0):
    (mj, sj), (mt, st) = out_j, out_t
    vj, vt = np.asarray(mj.valid), mt.valid.numpy()
    assert (vj == vt).mean() >= min_valid_share, (vj != vt).sum()
    # the same candidate where both matched (a float32 near-tie may flip)
    same = vj & vt & (np.abs(np.asarray(mj.disparity) - mt.disparity.numpy())
                      <= 1e-6 * np.abs(np.asarray(mj.disparity)))
    if min_valid_share == 1.0:
        assert same.sum() == (vj & vt).sum()
    np.testing.assert_allclose(mt.inv_depth.numpy()[same],
                               np.asarray(mj.inv_depth)[same], rtol=1e-6)
    np.testing.assert_allclose(mt.cost.numpy()[same],
                               np.asarray(mj.cost)[same], rtol=0, atol=1e-5)
    np.testing.assert_allclose(mt.x_right.numpy()[same],
                               np.asarray(mj.x_right)[same], rtol=1e-6)
    assert int(st["window_overflow"]) == int(sj["window_overflow"])
    assert st["window_overflow"].dtype == torch.int32
    return vj, vt


def _textured(rng, disp_true):
    base = rng.uniform(0, 255, size=(H, W + 32))
    k = np.ones(3) / 3
    base = np.apply_along_axis(lambda q: np.convolve(q, k, "same"), 1, base)
    return (base[:, 16:16 + W],
            base[:, 16 + int(disp_true):16 + int(disp_true) + W])


def test_correct_disparity_candidate_matches_jax():
    rng = np.random.default_rng(0)
    disp_true = 8.0
    ts_l, ts_r = _textured(rng, disp_true)
    N = 40
    lx = np.stack([rng.uniform(30, W - 20, N), rng.uniform(20, H - 20, N)],
                  axis=1)
    lt = np.sort(rng.uniform(0.0, 1e-3, N))
    lp = rng.random(N) > 0.5
    rx, rt, rp = [], [], []
    for i in range(N):
        rx += [[lx[i, 0] - disp_true, lx[i, 1]],
               [lx[i, 0] - disp_true - 14.0, lx[i, 1] + 3.0]]   # + a decoy
        rt += [lt[i], lt[i]]
        rp += [lp[i], lp[i]]
    order = np.argsort(rt, kind="stable")
    rx, rt, rp = (np.asarray(a)[order] for a in (rx, rt, rp))
    out = _run_both(ts_l, ts_r, lx, lt, lp, np.ones(N, bool), rx, rt, rp,
                    np.ones(len(rt), bool),
                    dict(time_threshold=1e-4, epipolar_threshold=0.5,
                         ts_ncc_threshold=0.2, patch_size_x=15,
                         patch_size_y=15, max_candidates=16))
    vj, vt = _assert_agree(*out)
    assert vt.mean() > 0.7


def test_padded_tail_and_mixed_polarity_match_jax():
    rng = np.random.default_rng(3)
    disp_true = 8.0
    ts_l, ts_r = _textured(rng, disp_true)
    N = 16
    lx = np.stack([rng.uniform(30, W - 20, N), rng.uniform(20, H - 20, N)],
                  axis=1)
    lt = np.sort(rng.uniform(1e-4, 1e-3, N))
    lp = np.ones(N, bool)
    rx, rt, rp = [], [], []
    for i in range(N):
        for _ in range(4):                       # wrong-polarity burst
            rx.append([lx[i, 0] - 30.0, lx[i, 1]])
            rt.append(lt[i] - 1e-6)
            rp.append(False)
        rx.append([lx[i, 0] - disp_true, lx[i, 1]])
        rt.append(lt[i])
        rp.append(True)
    order = np.argsort(rt, kind="stable")
    rx, rt, rp = (np.asarray(a)[order] for a in (rx, rt, rp))
    M, pad = len(rt), 64
    rx = np.concatenate([rx, np.zeros((pad, 2))])
    rt = np.concatenate([rt, np.zeros(pad)])
    rp = np.concatenate([rp, np.zeros(pad, bool)])
    rv = np.concatenate([np.ones(M, bool), np.zeros(pad, bool)])
    out = _run_both(ts_l, ts_r, lx, lt, lp, np.ones(N, bool), rx, rt, rp, rv,
                    dict(time_threshold=1e-4, epipolar_threshold=0.5,
                         ts_ncc_threshold=0.2, patch_size_x=15,
                         patch_size_y=15, max_candidates=2))
    vj, vt = _assert_agree(*out)
    assert vt.mean() > 0.7


def test_window_overflow_matches_jax():
    ts = np.zeros((H, W))
    M = 10
    rx = np.tile([[50.0, 40.0]], (M, 1))
    rt = np.linspace(1e-4, 9e-4, M)
    out = _run_both(ts, ts, [[60.0, 40.0]], [5e-4], [True], [True], rx, rt,
                    np.ones(M, bool), np.ones(M, bool),
                    dict(time_threshold=1e-3, max_candidates=4))
    _assert_agree(*out)
    assert int(out[1][1]["window_overflow"]) == 8


def test_band_window_ignores_off_row_clutter_like_jax():
    base = np.zeros((H, W))
    base[:, ::6] = 200.0
    rng = np.random.default_rng(0)
    M = 501
    rx = np.stack([rng.uniform(20, 100, M), rng.uniform(60, 80, M)], axis=1)
    rx[0] = [50.0, 40.0]
    rt = np.full(M, 4e-4)
    rt[0] = 5e-4
    order = np.argsort(rt, kind="stable")
    out = _run_both(base, np.roll(base, -10, axis=1), [[60.0, 40.0]], [5e-4],
                    [True], [True], rx[order], rt[order], np.ones(M, bool),
                    np.ones(M, bool),
                    dict(time_threshold=1e-3, max_candidates=8,
                         ts_ncc_threshold=0.6, patch_size_x=9,
                         patch_size_y=9))
    _assert_agree(*out)
    mt, st = out[1]
    assert bool(mt.valid[0]) and abs(float(mt.disparity[0]) - 10.0) < 1e-6
    assert int(st["window_overflow"]) == 0


@pytest.mark.parametrize("rx, rp", [([[52.0, 40.0]], [False]),
                                    ([[52.0, 43.0]], [True]),
                                    ([[70.0, 40.0]], [True])],
                         ids=["polarity", "epipolar", "negative_disparity"])
def test_polarity_and_epipolar_rejection_like_jax(rx, rp):
    ts = np.full((H, W), 100.0)
    out = _run_both(ts, ts, [[60.0, 40.0]], [0.0], [True], [True], rx,
                    np.zeros(len(rx)), rp, np.ones(len(rx), bool),
                    dict(time_threshold=1e-4, epipolar_threshold=0.5,
                         ts_ncc_threshold=0.9, patch_size_x=5,
                         patch_size_y=5, max_candidates=8))
    _assert_agree(*out)
    assert not bool(out[1][0].valid[0])


def test_float32_mixed_polarities_padded_tail_agree():
    """200 left events, each with a true right event and two decoys on
    its row, polarities mixed, 300 padding lanes (t = 0) at the tail; the
    event coordinates off the pixel grid."""
    rng = np.random.default_rng(7)
    disp_true = 6.0
    ts_l, ts_r = _textured(rng, disp_true)
    N = 200
    lx = np.stack([rng.uniform(30, W - 20, N), rng.uniform(12, H - 12, N)],
                  axis=1) + 0.37
    lt = np.sort(rng.uniform(0.0, 2e-3, N))
    lp = rng.random(N) > 0.5
    rx, rt, rp = [], [], []
    for i in range(N):
        for dx, dt in ((disp_true, 0.0), (disp_true + 5.0, 2e-5),
                       (disp_true - 3.0, -2e-5)):
            rx.append([lx[i, 0] - dx, lx[i, 1] + rng.uniform(-0.2, 0.2)])
            rt.append(lt[i] + dt)
            rp.append(lp[i] if dt == 0.0 else rng.random() > 0.5)
    order = np.argsort(rt, kind="stable")
    rx, rt, rp = (np.asarray(a)[order] for a in (rx, rt, rp))
    M, pad = len(rt), 300
    rx = np.concatenate([rx, np.zeros((pad, 2))])
    rt = np.concatenate([rt, np.zeros(pad)])
    rp = np.concatenate([rp, np.zeros(pad, bool)])
    rv = np.concatenate([np.ones(M, bool), np.zeros(pad, bool)])
    lv = rng.random(N) > 0.05
    out = _run_both(ts_l, ts_r, lx, lt, lp, lv, rx, rt, rp, rv,
                    dict(time_threshold=1e-4, epipolar_threshold=1.0,
                         ts_ncc_threshold=0.4, patch_size_x=15,
                         patch_size_y=15, max_candidates=32),
                    dtype=np.float32)
    vj, vt = _assert_agree(*out, min_valid_share=0.99)
    assert vt.mean() > 0.5


def test_sort_key_limits():
    """Times beyond 2^31 us from the origin saturate like XLA's convert;
    a surface too tall for the int32 key raises."""
    jrig, trig = _rigs(np.float64)
    cfg = tem.EventMatcherConfig(time_threshold=1e-3, patch_size_x=5,
                                 patch_size_y=5)
    tall = torch.zeros((1100, W), dtype=torch.float64)
    one = lambda *s, dt=torch.float64: torch.zeros(s, dtype=dt)
    with pytest.raises(ValueError, match="1024"):
        tem.match_events_temporal(
            tall, tall, one(1, 2), one(1), torch.ones(1, dtype=torch.bool),
            torch.ones(1, dtype=torch.bool),
            torch.eye(4, dtype=torch.float64)[None], one(1, 2), one(1),
            torch.ones(1, dtype=torch.bool), torch.ones(1, dtype=torch.bool),
            trig, cfg)
    ts = np.zeros((H, W))
    rt = np.array([0.0, 5e3])         # 5e9 us after the origin
    out = _run_both(ts, ts, [[60.0, 40.0]], [5e3], [True], [True],
                    [[50.0, 40.0], [50.0, 40.0]], rt, [True, True],
                    [True, True], dict(time_threshold=1e-3, patch_size_x=5,
                                       patch_size_y=5))
    _assert_agree(*out)
