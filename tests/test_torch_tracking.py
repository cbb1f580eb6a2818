"""The port's tracker (tracking/registration.py) against the JAX package's
on the same problem, built by each package's make_problem from the same
float32 numpy inputs.

Tolerances ("1e-4 relative" throughout: rtol 1e-4 with an absolute floor
of 1e-4 times the largest reference magnitude, since entries cross
zero):
- negative_time_surface (Gaussian blur 5 + Sobel), residuals_and_weights,
  analytic_jacobian, numerical_jacobian (3x3 patch);
- solve on the recovery world of tests/test_tracking.py (240x180) scaled
  down to 500 points in batches of 250: the pose within 1e-4 m and 1e-4
  rad of JAX's, per-round rms within 1e-3 relative, and the JAX test's
  own recovery bars (t_err < 0.008, R_err < 0.003).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.geometry.camera import make_ideal_rig as jrig
from esvo_tpu.geometry.se3 import cayley_to_rot, se3_matrix
from esvo_tpu.tracking import registration as jreg
from esvo_tpu_torch import convert
from esvo_tpu_torch.tracking import registration as treg

W, H, FX = 120, 90, 100.0
f32 = np.float32


def _rigs(w=W, h=H, fx=FX):
    rj = jrig(w, h, fx, fx, w / 2 - 0.5, h / 2 - 0.5, 0.1, dtype=jnp.float32)
    return rj, convert.rig_from_numpy(convert.rig_to_numpy(rj), device="cpu")


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    atol = rtol * max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _edge_surface(pts_world, T_world_cam, P, sigma=1.25, w=W, h=H):
    """255 at the projections of the points seen from T_world_cam,
    falling off with the distance to the nearest one (the edge pattern
    the tracker aligns to), float32."""
    Tinv = np.linalg.inv(T_world_cam)
    p = pts_world @ Tinv[:3, :3].T + Tinv[:3, 3]
    hom = p @ P[:, :3].T + P[:, 3]
    uv = (hom[:, :2] / hom[:, 2:3]).astype(f32)
    gu, gv = np.meshgrid(np.arange(w, dtype=f32), np.arange(h, dtype=f32))
    d2 = np.full((h, w), np.inf, f32)
    for u, v in uv:
        if -5 <= u < w + 5 and -5 <= v < h + 5:
            np.minimum(d2, (gu - u) ** 2 + (gv - v) ** 2, out=d2)
    return (255.0 * np.exp(-d2 / (2 * sigma ** 2))).astype(f32)


def _world(seed, M):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-0.3, 0.3, M), rng.uniform(-0.22, 0.22, M),
                    rng.uniform(0.8, 1.6, M)], 1).astype(f32)
    R_true = np.asarray(cayley_to_rot(jnp.asarray([0.004, -0.003, 0.002])))
    T_true = np.eye(4)
    T_true[:3, :3] = R_true
    T_true[:3, 3] = [0.015, -0.01, 0.02]
    return pts, T_true


def _problems(cfg_kw, ts, pts, T_ref, T_cur, valid=None):
    rj, rt = _rigs(ts.shape[1], ts.shape[0], FX * ts.shape[1] / W)
    M = len(pts)
    valid = np.ones(M, bool) if valid is None else valid
    cj = jreg.RegProblemConfig(**cfg_kw)
    ct = treg.RegProblemConfig(**cfg_kw)
    pj = jreg.make_problem(jnp.asarray(T_ref, jnp.float32),
                           jnp.asarray(T_cur, jnp.float32), jnp.asarray(pts),
                           jnp.asarray(valid), jnp.asarray(ts), cj)
    pt = treg.make_problem(torch.tensor(T_ref, dtype=torch.float32),
                           torch.tensor(T_cur, dtype=torch.float32),
                           torch.from_numpy(pts), torch.from_numpy(valid),
                           torch.from_numpy(ts), ct)
    return (pj, cj, rj.left), (pt, ct, rt.left)


@pytest.fixture(scope="module")
def problem():
    pts, T_true = _world(5, 400)
    rj, _ = _rigs()
    ts = _edge_surface(pts, T_true, np.asarray(rj.left.params.P, np.float64))
    T_ref = np.asarray(se3_matrix(cayley_to_rot(jnp.asarray([0.01, 0.0,
                                                             -0.02])),
                                  jnp.asarray([0.05, -0.02, 0.03])))
    valid = np.random.default_rng(6).random(len(pts)) > 0.1
    pts_w = (pts @ T_ref[:3, :3].T + T_ref[:3, 3]).astype(f32)
    return ts, pts_w, T_ref, T_ref @ T_true, valid


def test_make_problem_and_negative_surface(problem):
    ts, pts_w, T_ref, T_cur, valid = problem
    (pj, _, _), (pt, _, _) = _problems(dict(kernel_size=5), ts, pts_w, T_ref,
                                       T_cur, valid)
    for name in ("ts_negative", "grad_u", "grad_v", "points", "R", "t"):
        _close(getattr(pt, name).numpy(), getattr(pj, name))
    neg, gu, gv = treg.negative_time_surface(torch.from_numpy(ts), 0)
    np.testing.assert_array_equal(neg.numpy(), 255.0 - ts)


@pytest.mark.parametrize("ls_norm", ["Huber", "l2"])
def test_residuals_and_weights(problem, ls_norm):
    ts, pts_w, T_ref, T_cur, valid = problem
    (pj, cj, camj), (pt, ct, camt) = _problems(
        dict(kernel_size=5, ls_norm=ls_norm, huber_threshold=50.0), ts,
        pts_w, T_ref, T_cur, valid)
    x = np.array([1e-3, -2e-3, 5e-4, 4e-3, -2e-3, 1e-3], f32)
    fj, rj, okj = jreg.residuals_and_weights(pj, jnp.asarray(x), pj.points,
                                             pj.point_valid, camj, cj)
    ft, rt, okt = treg.residuals_and_weights(pt, torch.from_numpy(x),
                                             pt.points, pt.point_valid,
                                             camt, ct)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert 0.5 * len(pts_w) < okt.sum() < len(pts_w)
    _close(rt.numpy(), rj)
    _close(ft.numpy(), fj)


def test_analytic_jacobian(problem):
    ts, pts_w, T_ref, T_cur, valid = problem
    (pj, cj, camj), (pt, ct, camt) = _problems(dict(kernel_size=5), ts,
                                               pts_w, T_ref, T_cur, valid)
    Jj = jreg.analytic_jacobian(pj, pj.points, pj.point_valid, camj, cj)
    Jt = treg.analytic_jacobian(pt, pt.points, pt.point_valid, camt, ct)
    assert (np.abs(np.asarray(Jj)).sum(1) > 0).sum() > 200
    _close(Jt.numpy(), Jj)
    with pytest.raises(ValueError):
        treg.analytic_jacobian(pt, pt.points, pt.point_valid, camt,
                               treg.RegProblemConfig(patch_size_x=3))


def test_numerical_jacobian_3x3(problem):
    ts, pts_w, T_ref, T_cur, valid = problem
    kw = dict(kernel_size=5, patch_size_x=3, patch_size_y=3)
    (pj, cj, camj), (pt, ct, camt) = _problems(kw, ts, pts_w, T_ref, T_cur,
                                               valid)
    Jj = jreg.numerical_jacobian(pj, pj.points, pj.point_valid, camj, cj)
    Jt = treg.numerical_jacobian(pt, pt.points, pt.point_valid, camt, ct)
    assert Jt.shape == (len(pts_w) * 9, 6)
    assert (np.abs(np.asarray(Jj)).sum(1) > 0).sum() > 1000
    _close(Jt.numpy(), Jj)


def test_pose_of_and_motion_update():
    Rm = cayley_to_rot(jnp.asarray([0.1, -0.05, 0.02]))
    T_world_ref = np.asarray(se3_matrix(
        cayley_to_rot(jnp.asarray([0.05, 0.0, -0.01])),
        jnp.asarray([1.0, 2.0, 3.0])), f32)
    T_world_cur = (T_world_ref @ np.asarray(
        se3_matrix(Rm, jnp.asarray([0.3, 0.1, -0.2])))).astype(f32)
    z = np.zeros((H, W), f32)
    (pj, _, _), (pt, _, _) = _problems({}, z, np.zeros((4, 3), f32),
                                       T_world_ref, T_world_cur)
    _close(treg.pose_of(pt).numpy(), jreg.pose_of(pj))
    np.testing.assert_allclose(treg.pose_of(pt).numpy(), T_world_cur,
                               atol=1e-5)
    dx = np.array([0.01, -0.02, 0.005, 0.1, 0.0, -0.05], f32)
    for a, b in zip(treg.add_motion_update(pt.R, pt.t, torch.from_numpy(dx)),
                    jreg.add_motion_update(pj.R, pj.t, jnp.asarray(dx))):
        _close(a.numpy(), b)
    for a, b in zip(treg.warping_transformation(pt.R, pt.t,
                                                torch.from_numpy(dx)),
                    jreg.warping_transformation(pj.R, pj.t,
                                                jnp.asarray(dx))):
        _close(a.numpy(), b)


def _errors(T_est, T_true):
    """Translation distance and rotation angle (atan2 of the skew and
    symmetric parts: exact near zero, where arccos of the trace loses
    half the digits)."""
    t_err = np.linalg.norm(T_est[:3, 3] - T_true[:3, 3])
    E = T_est[:3, :3] @ T_true[:3, :3].T
    w = 0.5 * np.array([E[2, 1] - E[1, 2], E[0, 2] - E[2, 0],
                        E[1, 0] - E[0, 1]])
    return t_err, np.arctan2(np.linalg.norm(w), (np.trace(E) - 1) / 2)


@pytest.mark.parametrize("cfg_kw", [
    dict(kernel_size=0, batch_size=250, max_iteration=30),
    dict(kernel_size=5, batch_size=250, max_iteration=10),
], ids=["scaled-test_tracking", "rpg-tracker"])
def test_solve_matches_jax_and_recovers_pose(cfg_kw):
    """tests/test_tracking.py::test_solver_recovers_pose with 500 points
    in two rotating batches (and the rpg preset's blur and 10 rounds):
    identity guess, true pose a small motion away."""
    pts, T_true = _world(1, 500)
    rj, _ = _rigs(2 * W, 2 * H, 2 * FX)
    ts = _edge_surface(pts, T_true, np.asarray(rj.left.params.P, np.float64),
                       sigma=2.5, w=2 * W, h=2 * H)
    eye = np.eye(4)
    (pj, cj, camj), (pt, ct, camt) = _problems(
        dict(cfg_kw, lm_damping=1e-3, huber_threshold=50.0), ts, pts, eye,
        eye)
    _, Tj, rms_j = jax.jit(lambda p: jreg.solve(p, camj, cj))(pj)
    _, Tt, rms_t = treg.solve(pt, camt, ct)
    Tj, Tt = np.asarray(Tj, np.float64), Tt.double().numpy()
    t_diff, R_diff = _errors(Tt, Tj)
    assert t_diff < 1e-4 and R_diff < 1e-4, (t_diff, R_diff)
    np.testing.assert_allclose(rms_t.numpy(), np.asarray(rms_j), rtol=1e-3)
    assert rms_t[-1] < rms_t[0]
    if cfg_kw["max_iteration"] < 30:
        return      # the JAX test's bars are for its own settings
    # the initial offset is 0.0269 m and 0.0054 rad
    for T in (Tt, Tj):
        t_err, R_err = _errors(T, T_true)
        assert t_err < 0.008, f"translation error {t_err}"
        assert R_err < 0.003, f"rotation error {R_err}"
