"""Bilinear grid sampling (the warp in novel-view synthesis), NHWC boundary.

The JAX package re-implements ``torch.nn.functional.grid_sample``; here it
is the library op itself, with the layouts permuted at the edges.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def grid_sample(image: Tensor, grid: Tensor, *, padding_mode: str = "border",
                align_corners: bool = False) -> Tensor:
    """Sample ``image [B, H, W, C]`` at ``grid [B, Ho, Wo, 2]`` ((x, y) in
    [-1, 1]); returns ``[B, Ho, Wo, C]``."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    out = F.grid_sample(
        image.permute(0, 3, 1, 2), grid, mode="bilinear",
        padding_mode=padding_mode, align_corners=align_corners,
    )
    return out.permute(0, 2, 3, 1)
