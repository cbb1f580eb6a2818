"""Matmul-precision guard for pose and optimization math (port of
esvo_tpu/utils/precision.py).

On Ampere and later cards PyTorch may run float32 matmuls as TF32 (a
10-bit mantissa) when a process asks for it, for example with
``torch.set_float32_matmul_precision("high")``. For pose arithmetic,
Jacobians and normal equations that is fatal: LM increments of ~1e-3
against ~1-scale rotations drop below TF32's resolution (on the TPU the
JAX package saw the tracker diverge under the same kind of reduced
product). ``highest_precision`` runs a block, or a decorated function,
with full float32 matmuls whatever the caller set, and puts the caller's
setting back on exit, also when the block raises. A CUDA graph captured
inside it keeps the full-precision kernels it chose there.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def highest_precision():
    """Full float32 matmuls (``torch.backends.cuda.matmul.allow_tf32 ==
    False``, precision "highest") inside; the caller's setting after.
    Usable as ``with highest_precision():`` and as
    ``@highest_precision()``."""
    matmul = torch.backends.cuda.matmul
    try:
        saved = torch.get_float32_matmul_precision()
    except RuntimeError:
        # the caller set the generic precision and then the cuBLAS flag,
        # which leaves no one name to read back: keep the flag instead
        saved = None
        flag = matmul.allow_tf32
    if saved != "highest":
        torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if saved is None:
            matmul.allow_tf32 = flag
        elif saved != "highest":
            torch.set_float32_matmul_precision(saved)
