"""Kernel K4's dispatch and its plain twin (tracking/registration.py).

- ``registration.solve`` on CPU tensors is ``solve_plain`` bit for bit
  and never reaches the kernel's wrapper; the numerical Jacobian (or a
  larger patch) and dtypes other than float32 are solve_plain's by
  configuration (``kernel_takes``).
- The wrapper's argument checks (``ops/track.py``) raise on wrong dtypes,
  shapes and devices, and a CPU tensor never launches.
- The twin against JAX's ``registration.solve`` at a 480x640 surface
  (the DSEC size; tests/test_torch_tracking.py covers 240x180), both
  norms, M in {1, 299, 300, 2001} map points (below, at and around the
  batch of 300, and a count that is no multiple of it), 10% of them
  invalid: the pose within 1e-4 m and 1e-4 rad of JAX's and the
  per-round rms within 1e-3 relative (tests/test_torch_tracking.py's
  tolerances).
- Empty rounds, the identity K4 skips them by: with only the first
  n_valid of M = 2000 map points valid, a round whose batch holds no
  valid point leaves (R, t) bit for bit (the pose after the rounds
  before a run of empty rounds equals the pose after the run) and writes
  rms 0, in JAX's ``solve`` and in ``solve_plain`` alike, and the final
  poses agree within the tolerance above.
The kernel itself runs on the card only (tests/test_torch_cuda.py).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.geometry.camera import make_ideal_rig as jrig
from esvo_tpu.geometry.se3 import cayley_to_rot
from esvo_tpu.tracking import registration as jreg
from esvo_tpu_torch import convert
from esvo_tpu_torch.ops import track
from esvo_tpu_torch.tracking import registration as treg

W, H, FX = 640, 480, 400.0
f32 = np.float32


def _rigs():
    rj = jrig(W, H, FX, FX, W / 2 - 0.5, H / 2 - 0.5, 0.6,
              dtype=jnp.float32)
    return rj, convert.rig_from_numpy(convert.rig_to_numpy(rj), device="cpu")


def _world(M, seed=3):
    """M map points at 1.5-4 m, a true pose a small motion away from the
    identity guess, and an edge surface (255 at the true projections,
    a Gaussian fall-off) rendered from 1,500 of them."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-1.2, 1.2, M), rng.uniform(-0.9, 0.9, M),
                    rng.uniform(1.5, 4.0, M)], 1).astype(f32)
    T_true = np.eye(4)
    T_true[:3, :3] = np.asarray(cayley_to_rot(jnp.asarray(
        [0.003, -0.002, 0.002])))
    T_true[:3, 3] = [0.02, -0.015, 0.01]
    surf_pts = np.random.default_rng(seed + 1).choice(
        len(pts), min(len(pts), 1500), replace=False)
    Tinv = np.linalg.inv(T_true)
    p = pts[surf_pts] @ Tinv[:3, :3].T + Tinv[:3, 3]
    u = FX * p[:, 0] / p[:, 2] + W / 2 - 0.5
    v = FX * p[:, 1] / p[:, 2] + H / 2 - 0.5
    d2 = np.full((H, W), np.inf, f32)
    rad, sigma = 8, 2.5
    for uu, vv in zip(u, v):
        x0, y0 = int(np.floor(uu)) - rad, int(np.floor(vv)) - rad
        xs = np.arange(max(x0, 0), min(x0 + 2 * rad + 1, W))
        ys = np.arange(max(y0, 0), min(y0 + 2 * rad + 1, H))
        if xs.size and ys.size:
            dd = ((xs[None, :] - uu) ** 2 + (ys[:, None] - vv) ** 2)
            sub = d2[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1]
            np.minimum(sub, dd.astype(f32), out=sub)
    ts = (255.0 * np.exp(-d2 / (2 * sigma ** 2))).astype(f32)
    valid = np.random.default_rng(seed + 2).random(M) > 0.1
    return pts, valid, ts


def _problems(cfg_kw, pts, valid, ts):
    rj, rt = _rigs()
    cj = jreg.RegProblemConfig(**cfg_kw)
    ct = treg.RegProblemConfig(**cfg_kw)
    eye = np.eye(4, dtype=f32)
    pj = jreg.make_problem(jnp.asarray(eye), jnp.asarray(eye),
                           jnp.asarray(pts), jnp.asarray(valid),
                           jnp.asarray(ts), cj)
    pt = treg.make_problem(torch.from_numpy(eye), torch.from_numpy(eye),
                           torch.from_numpy(pts), torch.from_numpy(valid),
                           torch.from_numpy(ts), ct)
    return (pj, cj, rj.left), (pt, ct, rt.left)


def _errors(Ta, Tb):
    t_err = np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])
    E = Ta[:3, :3] @ Tb[:3, :3].T
    w = 0.5 * np.array([E[2, 1] - E[1, 2], E[0, 2] - E[2, 0],
                        E[1, 0] - E[0, 1]])
    return t_err, np.arctan2(np.linalg.norm(w), (np.trace(E) - 1) / 2)


@pytest.fixture(scope="module")
def small():
    pts, valid, ts = _world(400)
    return _problems(dict(kernel_size=5, batch_size=150), pts, valid, ts)


def test_cpu_solve_is_the_twin_and_never_reaches_the_wrapper(small,
                                                             monkeypatch):
    _, (pt, ct, camt) = small

    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached K4's wrapper")

    monkeypatch.setattr(track, "track_solve", refuse)
    prob, T, rms = treg.solve(pt, camt, ct)
    prob_p, T_p, rms_p = treg.solve_plain(pt, camt, ct)
    assert torch.equal(T, T_p) and torch.equal(rms, rms_p)
    assert torch.equal(prob.R, prob_p.R) and torch.equal(prob.t, prob_p.t)


@pytest.mark.parametrize("cfg_kw, dtype, takes", [
    (dict(), torch.float32, True),
    (dict(ls_norm="l2"), torch.float32, True),
    (dict(use_numerical_diff=True), torch.float32, False),
    (dict(patch_size_x=3, patch_size_y=3), torch.float32, False),
    (dict(), torch.float64, False),
], ids=["huber", "l2", "numerical", "patch3x3", "float64"])
def test_kernel_takes_only_the_analytic_float32_config(cfg_kw, dtype, takes):
    assert treg.kernel_takes(treg.RegProblemConfig(**cfg_kw), dtype) is takes


def _wrapper_args(M=5, Hs=6, Ws=7):
    return dict(R=torch.eye(3), t=torch.zeros(3), T_world_ref=torch.eye(4),
                points=torch.zeros(M, 3),
                point_valid=torch.ones(M, dtype=torch.bool),
                ts_negative=torch.zeros(Hs, Ws), grad_u=torch.zeros(Hs, Ws),
                grad_v=torch.zeros(Hs, Ws), P=torch.zeros(3, 4),
                mask=torch.ones(Hs, Ws, dtype=torch.bool))


@pytest.mark.parametrize("name, bad, exc", [
    ("R", torch.eye(3, dtype=torch.float64), TypeError),
    ("points", torch.zeros(5, 2), ValueError),
    ("point_valid", torch.ones(5), TypeError),
    ("point_valid", torch.ones(4, dtype=torch.bool), ValueError),
    ("grad_u", torch.zeros(6, 8), ValueError),
    ("mask", torch.ones(6, 7, dtype=torch.uint8), TypeError),
    ("P", torch.zeros(3, 3), ValueError),
    ("T_world_ref", torch.eye(4, device="meta"), ValueError),
], ids=["R-f64", "points-shape", "valid-dtype", "valid-len", "grad-shape",
        "mask-dtype", "P-shape", "device"])
def test_wrapper_checks_raise(name, bad, exc):
    args = _wrapper_args()
    track.check_inputs(**args)
    args[name] = bad
    with pytest.raises(exc):
        track.check_inputs(**args)


def test_wrapper_refuses_cpu_tensors():
    before = track.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        track.track_solve(**_wrapper_args(), batch_size=300, max_iteration=10,
                          huber=True, huber_threshold=50.0, lm_damping=1e-3)
    assert track.KERNEL.launches == before


@pytest.mark.parametrize("ls_norm", ["Huber", "l2"])
@pytest.mark.parametrize("M", [1, 299, 300, 2001])
def test_twin_matches_jax_at_dsec_size(M, ls_norm):
    pts, valid, ts = _world(M)
    (pj, cj, camj), (pt, ct, camt) = _problems(
        dict(kernel_size=5, ls_norm=ls_norm), pts, valid, ts)
    _, Tj, rms_j = jax.jit(lambda p: jreg.solve(p, camj, cj))(pj)
    _, Tt, rms_t = treg.solve(pt, camt, ct)
    t_diff, R_diff = _errors(Tt.double().numpy(), np.asarray(Tj, np.float64))
    assert t_diff < 1e-4 and R_diff < 1e-4, (t_diff, R_diff)
    np.testing.assert_allclose(rms_t.numpy(), np.asarray(rms_j), rtol=1e-3)
    if M >= 299:
        assert rms_t[-1] < rms_t[0]


def _empty_runs(empty):
    """Maximal runs [a, b) of True in the per-round list."""
    runs, a = [], None
    for it, e in enumerate(list(empty) + [False]):
        if e and a is None:
            a = it
        elif not e and a is not None:
            runs.append((a, it))
            a = None
    return runs


@pytest.mark.parametrize("n_valid, batch_size", [
    (600, 300), (1, 300), (300, 150)],
    ids=["600-of-2000", "1-of-2000", "300-of-2000-batch150"])
def test_empty_rounds_keep_the_pose_and_write_rms_zero(n_valid, batch_size):
    M = 2000
    pts, _, ts = _world(M)
    valid = np.arange(M) < n_valid
    cfg_kw = dict(kernel_size=5, batch_size=batch_size)
    (pj, cj, camj), (pt, ct, camt) = _problems(cfg_kw, pts, valid, ts)
    K = cj.max_iteration
    B, nb = min(batch_size, M), max(M // batch_size, 1)
    starts = [min((it % nb) * batch_size, M - B) for it in range(K)]
    empty = [not valid[s:s + B].any() for s in starts]
    runs = _empty_runs(empty)
    assert 0 < sum(empty) < K and runs

    def pose_j(k):
        c = jreg.RegProblemConfig(**cfg_kw, max_iteration=k)
        prob, T, rms = jax.jit(lambda p: jreg.solve(p, camj, c))(pj)
        return (np.asarray(prob.R), np.asarray(prob.t)), np.asarray(T), \
            np.asarray(rms)

    def pose_t(k):
        c = treg.RegProblemConfig(**cfg_kw, max_iteration=k)
        prob, T, rms = treg.solve_plain(pt, camt, c)
        return (prob.R.numpy(), prob.t.numpy()), T.numpy(), rms.numpy()

    for pose in (pose_j, pose_t):
        _, _, rms = pose(K)
        np.testing.assert_array_equal(rms[np.array(empty)], 0.0)
        assert (rms[~np.array(empty)] > 0).all()
        for a, b in runs:
            (Ra, ta), _, _ = pose(a)
            (Rb, tb), _, _ = pose(b)
            np.testing.assert_array_equal(Ra, Rb)
            np.testing.assert_array_equal(ta, tb)
    _, Tj, _ = pose_j(K)
    _, Tt, _ = pose_t(K)
    t_diff, R_diff = _errors(Tt.astype(np.float64), Tj.astype(np.float64))
    assert t_diff < 1e-4 and R_diff < 1e-4, (t_diff, R_diff)
