"""SE(3) rigid-transform utilities (batched torch, differentiable)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def se3_inverse(T: Tensor) -> Tensor:
    """Closed-form inverse of rigid transform(s) ``[..., 4, 4]``.

    ``inv([R | t]) = [R^T | -R^T t]`` (the reference's ``torch.pinverse``
    is exact only up to its SVD; the closed form is exact for SE(3)).
    """
    R = T[..., :3, :3]
    t = T[..., :3, 3:4]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ t)], dim=-1)
    bottom = torch.zeros_like(T[..., :1, :])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def camera_center(pose: Tensor) -> Tensor:
    """Reference-parity keyframe "center" ``-R^T t`` (not the true c2w center)."""
    R = pose[..., :3, :3]
    t = pose[..., :3, 3]
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


def transform_points(T: Tensor, points: Tensor) -> Tensor:
    """Apply rigid transform(s) ``[..., 4, 4]`` to points ``[..., N, 3]``."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return points @ R.transpose(-1, -2) + t[..., None, :]
