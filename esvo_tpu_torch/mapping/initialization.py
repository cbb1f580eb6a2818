"""Event denoising of the mapping cycle (the part of
esvo_tpu/mapping/initialization.py this port has so far; the SGM
bootstrap is not ported yet)."""
from __future__ import annotations

import torch

from esvo_tpu_torch.ops.interp import gather2d
from esvo_tpu_torch.surface.time_surface import median_blur_3x3


def denoising_mask(x_raw: torch.Tensor, y_raw: torch.Tensor,
                   valid: torch.Tensor, height: int,
                   width: int) -> torch.Tensor:
    """Median-blurred binary event map: flicker / isolated-event
    rejection (createDenoisingMask)."""
    ok = valid & (x_raw >= 0) & (x_raw < width) & (y_raw >= 0) \
        & (y_raw < height)
    idx = (torch.clamp(y_raw, 0, height - 1).long() * width
           + torch.clamp(x_raw, 0, width - 1).long())
    vals = torch.where(ok, 255.0, 0.0).to(torch.float32)
    emap = torch.zeros(height * width, dtype=torch.float32,
                       device=x_raw.device)
    emap.scatter_reduce_(0, idx, vals, "amax", include_self=True)
    return median_blur_3x3(emap.reshape(height, width)) >= 128.0


def select_denoised(x_raw: torch.Tensor, y_raw: torch.Tensor,
                    valid: torch.Tensor, mask: torch.Tensor,
                    max_num: int) -> torch.Tensor:
    """Keep the first `max_num` events whose raw pixel survives the mask
    (extractDenoisedEvents)."""
    H, W = mask.shape
    ok = valid & gather2d(mask, torch.clamp(y_raw, 0, H - 1),
                          torch.clamp(x_raw, 0, W - 1))
    rank = torch.cumsum(ok.to(torch.int32), dim=0)
    return ok & (rank <= max_num)
