"""Camera intrinsics utilities (4x4 homogeneous convention, as in gradslam)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def inverse_intrinsics(K: Tensor) -> Tensor:
    """Closed-form inverse of homogeneous pinhole intrinsics ``[..., 4, 4]``."""
    fx = K[..., 0, 0]
    fy = K[..., 1, 1]
    cx = K[..., 0, 2]
    cy = K[..., 1, 2]
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    return torch.stack(
        [
            torch.stack([1.0 / fx, zeros, -cx / fx, zeros], dim=-1),
            torch.stack([zeros, 1.0 / fy, -cy / fy, zeros], dim=-1),
            torch.stack([zeros, zeros, ones, zeros], dim=-1),
            torch.stack([zeros, zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )
