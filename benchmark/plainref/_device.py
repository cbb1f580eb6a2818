"""Frozen copy of esvo_tpu_torch/_device.py for the benchmark's plain
reference: the kernel dispatch is taken out, so every call runs the
plain twin; no precision guard inside (the caller sets the matmul
precision around a whole step). The original's text follows.

Device resolution and small device constants shared by the port."""
from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another (the CPU tests pass ``device="cpu"``)."""
    return torch.device("cuda" if device is None else device)


@functools.lru_cache(maxsize=None)
def constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, built once per
    (values, dtype, device). Building it copies from host memory, which a
    CUDA graph cannot capture; a cached constant is built before capture
    (by the warm-up) and only read inside it. Callers must not write to
    the result: every caller shares it."""
    return torch.tensor(values, dtype=dtype, device=device)
