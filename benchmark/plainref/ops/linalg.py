"""Frozen copy of esvo_tpu_torch/ops/linalg.py for the benchmark's plain
reference: the kernel dispatch is taken out, so every call runs the
plain twin; no precision guard inside (the caller sets the matmul
precision around a whole step). The original's text follows.

Small linear solves (port of esvo_tpu/ops/linalg.py, and the LU solve,
the segment sums and their cross-rank sum of the backend's normal
equations).

The tracker solves one 6x6 normal equation per LM round. The JAX package
unrolls the Cholesky factorization into scalar ops so that XLA fuses it
into the round; in eager PyTorch an unrolled 6x6 factorization is ~170
separate launches. Here it is the library factorization without its
error check (``cholesky_ex``: no host sync) and two triangular solves,
a handful of launches on either device.
"""
from __future__ import annotations

import torch


def solve_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for small symmetric positive-definite A (..., n, n).

    The same contract as the JAX package's: a singular or indefinite A
    gives a non-finite x (NaN here, wherever the factorization reports a
    failed pivot), and callers guard with ``torch.isfinite``. No host
    sync: the failure flag stays on the device."""
    n = A.shape[-1]
    if A.shape[-2:] != (n, n) or b.shape[-1] != n:
        raise ValueError(f"solve_spd wants (..., n, n) and (..., n), got "
                         f"{tuple(A.shape)} and {tuple(b.shape)}")
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
    return torch.where((info == 0)[..., None], x,
                       torch.full_like(x, float("nan")))


def solve_or_nan(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^-1 b by LU, NaN where A is singular, without a host sync:
    ``torch.linalg.solve`` raises on a singular (or non-finite) system
    where JAX's returns non-finite values; a non-finite step then fails
    the LM accept test, as in JAX."""
    x, info = torch.linalg.solve_ex(A, b)
    return torch.where(info == 0, x, torch.nan)


def segment_sum(values: torch.Tensor, index: torch.Tensor,
                n: int) -> torch.Tensor:
    """Sum of values (M, ...) into n rows by index (M,): JAX's
    ``zeros(...).at[index].add(values)``, in one fixed order on either
    device. On a CUDA tensor ``index_add_`` adds with atomics in whatever
    order the threads land, so a closed loop with the backend attached
    would not repeat itself; the sorted accumulate of ``index_put_``
    does. (On the CPU ``index_add_`` is the sequential one.)"""
    out = torch.zeros((n,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    if values.is_cuda:
        return out.index_put_((index,), values, accumulate=True)
    return out.index_add_(0, index, values)

