"""The port's event simulator (io/esim.py) against the JAX package, on
tests/test_esim.py's cases.

- The renderer: log intensity within 1e-4 (absolute) and depth within
  1e-5 (relative) of JAX's.
- The sensor with the noise off (no leak, no hot pixels; the only case
  where the two packages' event streams are defined to agree, since the
  noise draws come from different generators): event counts within
  0.5%, and at least 99.5% of events equal in x, y and polarity with t
  within 1 us (sorted by pixel, polarity and time). A pixel whose log
  intensity sits on a threshold can fire one crossing more or less when
  the renderer's float32 rounding differs in the last ulp.
- The thresholds, the hot-pixel sites and the noise seed equal JAX's bit
  for bit (the numpy generator consumed in JAX's order).
- tests/test_esim.py's physics checks on the port: counts against the
  contrast crossings, polarity, refractory, reproducibility, hot pixels,
  the overflow warning (its count within 0.5% of JAX's), the loop
  trajectory, and the dataset export read back by the port's loaders.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.io import esim as jesim
from esvo_tpu_torch.io import esim
from test_esim import W, H, K, linear_pose


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: these are thousands of small ops, and
    several test workers each running a full pool slow them tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


QUIET = dict(background_rate_hz=0.0, num_hot_pixels=0)


@pytest.fixture(scope="module")
def scene():
    return esim.make_room_scene(np.random.default_rng(11))


def _cfgs(**kw):
    return esim.SensorConfig(**kw), jesim.SensorConfig(**kw)


def _sim(mod, scene, cfg, pose, t1, seed, **kw):
    if mod is esim:
        kw["device"] = "cpu"
    return mod.simulate_camera(scene, K, W, H, pose, 0.0, t1, cfg,
                               np.random.default_rng(seed), **kw)


def _match_share(a, b) -> float:
    """Share of events of the larger stream that the other holds too:
    equal in (x, y, p) with t on the same microsecond (a multiset
    intersection, so one extra crossing shifts nothing)."""
    def keys(e):
        pix = (e.y.astype(np.int64) * W + e.x) * 2 + e.p
        return np.sort((pix << 32) + np.round(e.t * 1e6).astype(np.int64))
    ka, kb = keys(a), keys(b)
    ua, ca = np.unique(ka, return_counts=True)
    ub, cb = np.unique(kb, return_counts=True)
    _, ia, ib = np.intersect1d(ua, ub, return_indices=True)
    common = np.minimum(ca[ia], cb[ib]).sum()
    return float(common) / max(len(a), len(b), 1)


def test_scene_matches_jax():
    a = esim.make_room_scene(np.random.default_rng(11))
    b = jesim.make_room_scene(np.random.default_rng(11))
    for f in ("p0", "e1", "n", "tex_amp", "tex_freq", "edge_phase"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("t", [0.0, 0.5])
def test_render_matches_jax(scene, t):
    L, D = esim.render_log_intensity(
        scene, torch.as_tensor(linear_pose(t), dtype=torch.float32), K, W, H)
    jL, jD = jesim.render_log_intensity(
        scene, jnp.asarray(linear_pose(t), jnp.float32),
        jnp.asarray(K, jnp.float32), W, H)
    assert L.dtype == D.dtype == torch.float32
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), atol=1e-4)
    np.testing.assert_allclose(D.numpy(), np.asarray(jD), rtol=1e-5)
    d = D.numpy()
    assert np.isfinite(d).all() and (d > 0).all()
    if t == 0.0:
        assert d[H // 2, W // 2] == pytest.approx(4.0, abs=1e-3)
        assert d.min() < d[H // 2, W // 2] - 0.3
    else:
        L0, _ = esim.render_log_intensity(
            scene, torch.eye(4), K, W, H)
        assert float(torch.mean(torch.abs(L - L0))) > 1e-3


def test_sensor_maps_equal_jax_bit_for_bit(monkeypatch):
    """c_pos / c_neg / the leak map (hot-pixel sites) and the noise seed
    equal the arrays JAX's simulate_camera hands its scan."""
    seen = {}
    make = jesim._make_camera_step

    def spy_make(*a, **kw):
        fn, *rest = make(*a, **kw)

        def spy(carry, poses, tt, c_pos, c_neg, leak):
            seen.setdefault("maps", (np.asarray(c_pos), np.asarray(c_neg),
                                     np.asarray(leak)))
            return fn(carry, poses, tt, c_pos, c_neg, leak)
        return (spy, *rest)

    key = jax.random.PRNGKey

    def spy_key(seed):
        seen["seed"] = int(seed)
        return key(seed)
    monkeypatch.setattr(jesim, "_make_camera_step", spy_make)
    monkeypatch.setattr(jesim.jax.random, "PRNGKey", spy_key)
    _, jcfg = _cfgs(num_hot_pixels=8, hot_pixel_rate_hz=1000.0)
    cfg, _ = _cfgs(num_hot_pixels=8, hot_pixel_rate_hz=1000.0)
    jesim.simulate_camera(esim.make_room_scene(np.random.default_rng(1)),
                          K, W, H, linear_pose, 0.0, 0.008, jcfg,
                          np.random.default_rng(5), chunk_steps=8)
    c_pos, c_neg, leak, seed = esim._sensor_maps(cfg, W, H,
                                                 np.random.default_rng(5))
    for ours, theirs in zip((c_pos, c_neg, leak), seen["maps"]):
        assert ours.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)
    assert seed == seen["seed"]
    assert (leak == 1.0).sum() == 8


@pytest.fixture(scope="module")
def quiet_runs(scene):
    cfg, jcfg = _cfgs(threshold_fpn_sigma=0.0, refractory_us=50.0, **QUIET)
    ev, stats = _sim(esim, scene, cfg, linear_pose, 0.3, 0)
    jev, jstats = _sim(jesim, scene, jcfg, linear_pose, 0.3, 0)
    return ev, stats, jev, jstats, cfg


def test_noise_free_events_match_jax(quiet_runs):
    ev, stats, jev, jstats, _ = quiet_runs
    assert stats["overflow_dropped"] == jstats["overflow_dropped"] == 0
    assert abs(len(ev) - len(jev)) <= 0.005 * len(jev)
    assert _match_share(ev, jev) >= 0.995
    assert ev.t.dtype == np.float64 and np.all(np.diff(ev.t) >= 0)


def test_noise_free_events_with_fpn_match_jax(scene):
    """Fixed-pattern thresholds (the bit-equal maps) with the noise off."""
    cfg, jcfg = _cfgs(**QUIET)
    ev, _ = _sim(esim, scene, cfg, linear_pose, 0.15, 7)
    jev, _ = _sim(jesim, scene, jcfg, linear_pose, 0.15, 7)
    assert abs(len(ev) - len(jev)) <= 0.005 * len(jev)
    assert _match_share(ev, jev) >= 0.995


def test_counts_match_contrast_crossings(quiet_runs, scene):
    ev, stats, _, _, cfg = quiet_runs
    steps = np.arange(0.0, 0.3 + 1e-9, cfg.substep_dt)
    render = lambda t: esim.render_log_intensity(
        scene, torch.as_tensor(linear_pose(float(t)), dtype=torch.float32),
        K, W, H)[0].numpy()
    expected = np.zeros((H, W))
    ref = render(0.0)
    for t in steps[1:]:
        L = render(t)
        n = np.minimum(np.floor(np.abs(L - ref) / cfg.contrast_threshold),
                       cfg.max_events_per_px_step)
        expected += n
        ref = ref + np.sign(L - ref) * n * cfg.contrast_threshold
    assert expected.sum() > 500, "scene too static for the test"
    assert abs(len(ev) - expected.sum()) / expected.sum() < 0.02


def test_polarity_tracks_intensity_change(quiet_runs, scene):
    ev, _, _, _, cfg = quiet_runs
    render = lambda t: esim.render_log_intensity(
        scene, torch.as_tensor(linear_pose(float(t)), dtype=torch.float32),
        K, W, H)[0].numpy()
    sub = np.random.default_rng(1).choice(len(ev), size=400, replace=False)
    agree = 0
    for i in sub:
        t0 = np.floor(ev.t[i] / cfg.substep_dt) * cfg.substep_dt
        d = render(t0 + cfg.substep_dt)[ev.y[i], ev.x[i]] \
            - render(t0)[ev.y[i], ev.x[i]]
        agree += (d >= 0) == bool(ev.p[i])
    assert agree / len(sub) > 0.9


def test_refractory_period_enforced(scene):
    cfg, _ = _cfgs(threshold_fpn_sigma=0.0, refractory_us=5000.0, **QUIET)
    ev, _ = _sim(esim, scene, cfg, linear_pose, 0.25, 0)
    pix = ev.y.astype(np.int64) * W + ev.x
    order = np.lexsort((ev.t, pix))
    same = pix[order][1:] == pix[order][:-1]
    dt = np.diff(ev.t[order])[same]
    assert len(dt) > 50
    assert dt.min() >= 5000e-6 - 1e-9


def test_reproducible_with_same_seed(scene):
    cfg = esim.SensorConfig()
    ev1, s1 = _sim(esim, scene, cfg, linear_pose, 0.1, 5)
    ev2, s2 = _sim(esim, scene, cfg, linear_pose, 0.1, 5)
    assert s1 == s2
    np.testing.assert_array_equal(ev1.t, ev2.t)
    np.testing.assert_array_equal(ev1.x, ev2.x)
    np.testing.assert_array_equal(ev1.p, ev2.p)


def test_hot_pixels_fire_at_high_rate(scene):
    kw = dict(background_rate_hz=0.0, num_hot_pixels=2,
              hot_pixel_rate_hz=1000.0, threshold_fpn_sigma=0.0)
    cfg, jcfg = _cfgs(**kw)
    static = lambda t: np.eye(4)
    ev, _ = _sim(esim, scene, cfg, static, 0.2, 2)
    jev, _ = _sim(jesim, scene, jcfg, static, 0.2, 2)
    pix, counts = np.unique(ev.y.astype(np.int64) * W + ev.x,
                            return_counts=True)
    jpix = np.unique(jev.y.astype(np.int64) * W + jev.x)
    assert len(pix) == 2 and (pix == jpix).all()
    assert counts.min() > 0.5 * 0.2 / cfg.substep_dt


def test_overflow_counted_and_warned(scene):
    kw = dict(event_budget_per_step=16, **QUIET)
    cfg, jcfg = _cfgs(**kw)
    with pytest.warns(UserWarning, match="budget dropped"):
        ev, stats = _sim(esim, scene, cfg, linear_pose, 0.2, 0)
    with pytest.warns(UserWarning, match="budget dropped"):
        _, jstats = _sim(jesim, scene, jcfg, linear_pose, 0.2, 0)
    assert stats["overflow_dropped"] > 0
    assert stats["events"] == len(ev) <= 16 * 200
    assert abs(stats["overflow_dropped"] - jstats["overflow_dropped"]) \
        <= 0.005 * jstats["overflow_dropped"]


def test_loop_trajectory_closes():
    dur = 32.0
    T0 = esim.loop_trajectory_pose(0.0, dur, laps=2)
    np.testing.assert_allclose(T0, np.eye(4), atol=1e-12)
    for t in (dur / 2, dur):
        np.testing.assert_allclose(esim.loop_trajectory_pose(t, dur, laps=2),
                                   T0, atol=1e-9)
    Tm = esim.loop_trajectory_pose(dur / 8, dur, laps=2)
    np.testing.assert_array_equal(Tm, jesim.loop_trajectory_pose(
        dur / 8, dur, laps=2))
    assert np.linalg.norm(Tm[:3, 3]) > 0.3


def test_export_dataset_roundtrip(scene, tmp_path):
    from esvo_tpu_torch.io.datasets import load_rpg_dataset
    from esvo_tpu_torch.geometry.camera import load_rig
    baseline = 0.1
    ev_l, ev_r, stats = esim.simulate_stereo(
        scene, K, W, H, baseline, linear_pose, 0.0, 0.1,
        esim.SensorConfig(), np.random.default_rng(3), device="cpu")
    assert stats["left"]["events"] > 0 and stats["right"]["events"] > 0
    gt_t = np.linspace(0.0, 0.1, 11)
    gt_T = np.stack([linear_pose(t) for t in gt_t])
    out = str(tmp_path / "sim")
    esim.export_dataset(out, scene, K, W, H, baseline, ev_l, ev_r,
                        gt_t, gt_T, meta={"note": "test"})
    l2, r2, t2, T2 = load_rpg_dataset(out)
    assert len(l2) == len(ev_l) and len(r2) == len(ev_r)
    np.testing.assert_array_equal(l2.x, ev_l.x)
    np.testing.assert_allclose(l2.t, ev_l.t, atol=1e-9)
    np.testing.assert_allclose(t2, gt_t, atol=1e-9)
    np.testing.assert_allclose(T2, gt_T, atol=1e-6)
    rig = load_rig(os.path.join(out, "calib"), device="cpu")
    assert float(rig.baseline) == pytest.approx(baseline, abs=1e-6)
    assert rig.left.width == W and rig.left.height == H
    np.testing.assert_allclose(rig.left.params.P.double().numpy()[:, :3], K,
                               atol=1e-5)
    scene2 = esim.PlaneScene.load(os.path.join(out, "scene.npz"))
    np.testing.assert_allclose(scene2.p0, scene.p0)
    # the JAX package's loader reads the port's export too
    from esvo_tpu.io.datasets import load_rpg_dataset as jload
    jl, *_ = jload(out)
    np.testing.assert_array_equal(jl.y, ev_l.y)
