"""The port's small SPD solve and its SE(3) additions against the JAX
package: solve_spd to rtol 1e-4 on random SPD systems, and a non-PD
matrix gives dx = 0 in both once the caller's isfinite guard has run
(the tracker's contract); se3_compose, transform_points,
orthonormalize_rotation (SVD), orthonormalize_rotation_fast and
matrices_from_rows to 1e-6; segment_sum equal to JAX's scatter-add."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.geometry import se3 as jse3
from esvo_tpu.ops.linalg import solve_spd as jsolve
from esvo_tpu_torch.geometry import se3 as tse3
from esvo_tpu_torch.ops.linalg import segment_sum
from esvo_tpu_torch.ops.linalg import solve_spd as tsolve

f32 = np.float32


def _guarded(x):
    return np.where(np.isfinite(x), x, 0.0)


@pytest.mark.parametrize("n", [3, 6])
def test_solve_spd_random(n):
    rng = np.random.default_rng(n)
    for _ in range(5):
        A = rng.standard_normal((n, n))
        A = (A @ A.T + n * np.eye(n)).astype(f32)
        b = rng.standard_normal(n).astype(f32)
        xj = np.asarray(jsolve(jnp.asarray(A), jnp.asarray(b)))
        xt = tsolve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(xt, xj, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(xt, np.linalg.solve(A, b), rtol=1e-4,
                                   atol=1e-6)


def test_solve_spd_batched_and_shape_check():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((4, 6, 6))
    A = (A @ A.transpose(0, 2, 1) + 6 * np.eye(6)).astype(f32)
    b = rng.standard_normal((4, 6)).astype(f32)
    xt = tsolve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(xt, np.linalg.solve(A, b[..., None])[..., 0],
                               rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError):
        tsolve(torch.zeros(3, 3), torch.zeros(4))


@pytest.mark.parametrize("kind", ["indefinite", "negative", "nan"])
def test_solve_spd_non_pd_gives_zero_step(kind):
    rng = np.random.default_rng(2)
    A = rng.standard_normal((6, 6))
    A = A @ A.T + 6 * np.eye(6)
    if kind == "indefinite":
        A[3, 3] = -50.0
    elif kind == "negative":
        A = -A
    else:
        A[2, 2] = np.nan
    A = A.astype(f32)
    b = rng.standard_normal(6).astype(f32)
    xj = _guarded(np.asarray(jsolve(jnp.asarray(A), jnp.asarray(b))))
    xt = tsolve(torch.from_numpy(A), torch.from_numpy(b))
    xt = torch.where(torch.isfinite(xt), xt, torch.zeros_like(xt)).numpy()
    np.testing.assert_array_equal(xt, np.zeros(6))
    np.testing.assert_array_equal(xj, np.zeros(6))


def _poses(rng, n):
    xi = rng.normal(0, 0.4, (n, 6)).astype(f32)
    return np.asarray(jse3.se3_exp(jnp.asarray(xi)), f32)


def test_se3_additions():
    rng = np.random.default_rng(3)
    A, B = _poses(rng, 5), _poses(rng, 5)
    t = lambda a: torch.tensor(a)
    np.testing.assert_allclose(
        tse3.se3_compose(t(A), t(B)).numpy(),
        np.asarray(jse3.se3_compose(jnp.asarray(A), jnp.asarray(B))),
        atol=1e-6)
    p = rng.normal(0, 2, (5, 7, 3)).astype(f32)
    np.testing.assert_allclose(
        tse3.transform_points(t(A)[:, None], t(p)).numpy(),
        np.asarray(jse3.transform_points(jnp.asarray(A)[:, None],
                                         jnp.asarray(p))), atol=1e-6)
    rows = np.asarray(jse3.rows_from_matrices(jnp.asarray(A)))
    np.testing.assert_array_equal(
        tse3.matrices_from_rows(t(rows)).numpy(),
        np.asarray(jse3.matrices_from_rows(jnp.asarray(rows))))
    np.testing.assert_array_equal(tse3.matrices_from_rows(t(rows)).numpy(),
                                  A)


def test_orthonormalize_rotation():
    rng = np.random.default_rng(4)
    R = _poses(rng, 6)[:, :3, :3]
    # near SO(3): the drift of products of rotations (fast form's domain)
    near = (R + rng.normal(0, 1e-4, R.shape)).astype(f32)
    # far from SO(3), with one reflection (det < 0) for the SVD form
    far = (R + rng.normal(0, 0.2, R.shape)).astype(f32)
    far[0] = far[0] @ np.diag([1, 1, -1]).astype(f32)
    t = torch.from_numpy
    for M in (near, far):
        got = tse3.orthonormalize_rotation(t(M)).numpy()
        want = np.asarray(jse3.orthonormalize_rotation(jnp.asarray(M)))
        np.testing.assert_allclose(got, want, atol=1e-6)
        np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)
    for M in (near, near[0]):          # batched and single matrices
        np.testing.assert_allclose(
            tse3.orthonormalize_rotation_fast(t(M)).numpy(),
            np.asarray(jse3.orthonormalize_rotation_fast(jnp.asarray(M))),
            atol=1e-6)


def test_segment_sum_is_jax_scatter_add():
    """segment_sum equals JAX's zeros(...).at[index].add(values) on the
    CPU (repeated indices, empty rows, trailing dims), within 1e-12 in
    float64."""
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 9, size=500)
    vals = rng.normal(size=(500, 2, 3))
    want = np.asarray(jnp.zeros((12, 2, 3)).at[jnp.asarray(idx)].add(
        jnp.asarray(vals)))
    got = segment_sum(torch.as_tensor(vals), torch.as_tensor(idx), 12)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
