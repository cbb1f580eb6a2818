"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another (the CPU tests pass ``device="cpu"``)."""
    return torch.device("cuda" if device is None else device)
