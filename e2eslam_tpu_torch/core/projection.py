"""Backprojection and projection for novel-view synthesis (NHWC at the boundary).

The reference's ``BackprojectDepth`` / ``Project3D``
(``depth_estimation/view_synthesis.py:7-78``):

  * backproject: ``cam_points = depth * (K^-1 @ pix_h)``;
  * project: ``P = (K @ T)[:3]``, perspective divide by ``z + 1e-7``, pixel
    coords normalised by ``(W-1, H-1)`` to ``[-1, 1]``, validity mask
    ``max(|u|, |v|) <= 1``.

The ``(W-1)`` normalisation sampled with ``align_corners=False`` carries the
reference's half-pixel offset; it is kept for parity.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

EPS = 1e-7


def pixel_grid(height: int, width: int, dtype=torch.float32, device=None) -> Tensor:
    """Homogeneous pixel grid ``[3, H*W]`` with rows (x, y, 1), 'xy' indexing."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=dtype, device=device),
        torch.arange(width, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([xs.reshape(-1), ys.reshape(-1), torch.ones_like(xs).reshape(-1)])


def backproject(depth: Tensor, inv_K: Tensor) -> Tensor:
    """Lift ``[B, H, W(, 1)]`` depth to ``[B, H, W, 3]`` camera-frame points."""
    if depth.ndim == 4:
        depth = depth[..., 0]
    B, H, W = depth.shape
    pix = pixel_grid(H, W, depth.dtype, depth.device)
    rays = inv_K[:, :3, :3].to(depth.dtype) @ pix  # [B, 3, HW]
    pts = rays * depth.reshape(B, 1, H * W)
    return pts.permute(0, 2, 1).reshape(B, H, W, 3)


def project(points: Tensor, K: Tensor, T: Tensor) -> Tuple[Tensor, Tensor]:
    """Project ``[B, H, W, 3]`` camera points through ``T`` and ``K``.

    Returns ``(grid [B,H,W,2], valid [B,H,W,1])``.
    """
    B, H, W, _ = points.shape
    P = (K @ T)[:, :3, :].to(points.dtype)  # [B, 3, 4]
    pts_h = torch.cat(
        [points.reshape(B, H * W, 3), points.new_ones(B, H * W, 1)], dim=-1
    )
    cam = pts_h @ P.transpose(-1, -2)  # [B, HW, 3]
    z = cam[..., 2:3]
    # Divide by (z + eps), with a sign-preserving clamp that keeps the
    # divide's derivative bounded for points on the camera plane.
    denom = z + EPS
    denom = torch.where(denom >= 0, denom.clamp(min=1e-5), denom.clamp(max=-1e-5))
    uv = cam[..., :2] / denom
    uv = torch.stack([uv[..., 0] / (W - 1), uv[..., 1] / (H - 1)], dim=-1)
    grid = ((uv - 0.5) * 2.0).reshape(B, H, W, 2)
    valid = (grid.abs().amax(dim=-1, keepdim=True) <= 1.0).to(points.dtype)
    return grid, valid
