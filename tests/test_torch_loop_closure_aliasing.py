"""Loop-closure robustness of the port under perceptual aliasing
(tests/test_loop_closure_aliasing.py's case): an esim room whose four
walls share one texture, two laps of a full-yaw orbit, keyframes from
the port's renderer, and the port's detector and ICP verification in
the call sequence of PoseGraphLoop.maybe_update.

Held to that test's contract (at least three proposals, at least one
aliased, at least one true edge accepted, no false edge accepted), and
the descriptors to JAX's on the same keyframes within 1e-6 (the keyframe
surfaces come from the port's renderer, which matches JAX's within
1e-4, tests/test_torch_esim.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.backend import loop_closure as jlc
from esvo_tpu_torch.backend import loop_closure as lc
from esvo_tpu_torch.io import esim
from test_loop_closure_aliasing import (DUR, FX, H, K, N_KF, N_PTS, W,
                                        orbit_pose, rel_gap)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def aliased_scene():
    scene = esim.make_room_scene(np.random.default_rng(21))
    for f in ("tex_amp", "tex_freq", "tex_phase",
              "edge_amp", "edge_freq", "edge_phase"):
        a = getattr(scene, f)
        for p in (1, 2, 5):
            a[p] = a[0]
    return scene


def render_keyframe(scene, T, rng):
    """(proxy time surface, semi-dense camera-frame cloud), as the JAX
    test builds them, from the port's renderer."""
    logI, depth = esim.render_log_intensity(
        scene, torch.as_tensor(T, dtype=torch.float32), K, W, H)
    logI, depth = logI.numpy(), depth.numpy()
    g = np.abs(np.diff(logI, axis=1, prepend=logI[:, :1])) \
        + np.abs(np.diff(logI, axis=0, prepend=logI[:1]))
    ts = np.clip(g / (g.max() + 1e-9) * 255.0, 0, 255)
    ys, xs = np.unravel_index(np.argsort(g, axis=None)[::-1][:N_PTS],
                              g.shape)
    z = depth[ys, xs]
    p_cam = np.stack([(xs - K[0, 2]) / FX * z,
                      (ys - K[1, 2]) / FX * z, z], axis=1)
    p_cam += rng.normal(scale=0.004, size=p_cam.shape)
    return torch.as_tensor(ts, dtype=torch.float32), p_cam


def test_aliasing_false_positive_rate():
    scene = aliased_scene()
    rng = np.random.default_rng(0)
    cfg = lc.LoopClosureConfig(min_similarity=0.45, min_gap=6)
    det = lc.LoopClosureDetector(cfg, device="cpu")
    kfs, accepted = [], []
    proposals = aliased = 0
    for t in np.linspace(0.0, DUR, N_KF, endpoint=False):
        T_gt = orbit_pose(t)
        ts, cloud = render_keyframe(scene, T_gt, rng)
        desc = lc.ts_descriptor(ts, cfg.desc_grid)
        np.testing.assert_allclose(
            desc.numpy(), np.asarray(jlc.ts_descriptor(
                jnp.asarray(ts.numpy()), cfg.desc_grid)), atol=1e-6)
        cand, sim = det.query_descriptor(desc)
        if cand >= 0 and sim >= cfg.min_similarity and cand < len(kfs):
            proposals += 1
            t_c, T_c, cloud_c = kfs[cand]
            gt_t, gt_r = rel_gap(T_c, T_gt)
            if gt_t > 0.25 or gt_r > 0.35:
                aliased += 1
            T_est = T_gt.copy()
            T_est[:3, 3] += rng.normal(scale=0.03, size=3)
            f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
            ok, T_edge, *_ = lc.verify_loop_icp(
                f32(cloud_c), torch.ones(len(cloud_c), dtype=torch.bool),
                f32(cloud), torch.ones(len(cloud), dtype=torch.bool),
                T_c, T_est, cfg)
            if ok:
                accepted.append((T_c, T_gt, T_edge))
        det.add_descriptor(desc)
        kfs.append((t, T_gt, cloud))
    assert proposals >= 3, f"only {proposals} candidate loops"
    assert aliased >= 1, "no aliased proposal reached the geometric gate"
    tp = fp = 0
    for T_i, T_j, T_edge in accepted:
        dT = np.linalg.inv(np.linalg.inv(T_i) @ T_j) @ T_edge
        ang = np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1))
        if np.linalg.norm(dT[:3, 3]) <= 0.10 and ang <= 0.20:
            tp += 1
        else:
            fp += 1
    assert tp >= 1, f"no true loop edges accepted ({len(accepted)} total)"
    assert fp == 0, f"{fp} false edges of {len(accepted)} ({proposals} " \
                    f"proposals, {aliased} aliased)"
