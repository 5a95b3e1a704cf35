"""Camera intrinsics utilities (4x4 homogeneous convention, as in gradslam)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def make_intrinsics(fx, fy, cx, cy, dtype=torch.float32, device=None) -> Tensor:
    """A homogeneous ``[4, 4]`` pinhole intrinsics matrix."""
    K = torch.eye(4, dtype=dtype, device=device)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    return K


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


def normalize_intrinsics(K: Tensor, width: float = 640.0, height: float = 480.0) -> Tensor:
    """Divide the first two rows of K by the native sensor resolution (the
    reference's monodepth2 normalisation, ``utils/training_utils.py:154-174``:
    640 x 480 for ICL and TUM alike)."""
    scale = torch.ones(4, 1, dtype=K.dtype, device=K.device)
    scale[0, 0], scale[1, 0] = 1.0 / width, 1.0 / height
    return K * scale


def scale_intrinsics(K: Tensor, sx: float, sy: float) -> Tensor:
    """Intrinsics for images resized by (``sx``, ``sy``): the first row
    times ``sx``, the second times ``sy``."""
    scale = torch.tensor([[sx], [sy], [1.0], [1.0]], dtype=K.dtype, device=K.device)
    return K * scale
