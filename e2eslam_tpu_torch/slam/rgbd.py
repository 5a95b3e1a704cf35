"""RGB-D frame geometry: vertex maps, normal maps, world-frame lifting.

A frame is a plain container of NHWC tensors (unbatched ``[H, W, ...]``),
the counterpart of gradslam's ``RGBDImages``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from e2eslam_tpu_torch.core.camera import inverse_intrinsics
from e2eslam_tpu_torch.core.projection import backproject
from e2eslam_tpu_torch.core.se3 import transform_points

Tensor = torch.Tensor


class RGBDFrame(NamedTuple):
    """A single RGB-D frame (unbatched: [H, W, ...])."""

    color: Tensor  # [H, W, 3] in [0, 1]
    depth: Tensor  # [H, W, 1]
    intrinsics: Tensor  # [4, 4]
    pose: Tensor  # [4, 4] camera-to-world
    vertices: Tensor  # [H, W, 3] world-frame vertex map
    normals: Tensor  # [H, W, 3] world-frame normal map
    valid: Tensor  # [H, W, 1] float: depth > 0


def vertex_map(depth: Tensor, intrinsics: Tensor) -> Tensor:
    """Camera-frame vertex map [H, W, 3] from depth [H, W, 1] and K [4, 4]."""
    return backproject(depth[None], inverse_intrinsics(intrinsics)[None])[0]


def normal_map(vertices: Tensor) -> Tensor:
    """Per-pixel normals ``normalize((v[y, x+1] - v) x (v[y+1, x] - v))``.

    The last row/column has no forward difference and gets a zero one,
    hence a zero normal, so border pixels never pass the fusion angle gate:
    the JAX package's ``edge="zero"``, its deliberate choice over
    gradslam's replicated edge.
    """
    dx = vertices[:, 1:] - vertices[:, :-1]
    dy = vertices[1:] - vertices[:-1]
    dx = torch.cat([dx, torch.zeros_like(dx[:, -1:])], dim=1)
    dy = torch.cat([dy, torch.zeros_like(dy[-1:])], dim=0)
    n = torch.linalg.cross(dx, dy, dim=-1)
    n2 = (n * n).sum(dim=-1, keepdim=True)
    ok = n2 > 1e-24
    safe = torch.where(ok, n2, torch.ones_like(n2))
    return torch.where(ok, n / safe.sqrt(), torch.zeros_like(n))


def build_frame(color: Tensor, depth: Tensor, intrinsics: Tensor,
                pose: Optional[Tensor] = None) -> RGBDFrame:
    """Assemble an RGBDFrame, computing world vertex/normal maps."""
    if depth.ndim == 2:
        depth = depth[..., None]
    if pose is None:
        pose = torch.eye(4, dtype=depth.dtype, device=depth.device)
    H, W = depth.shape[:2]
    v_cam = vertex_map(depth, intrinsics)
    v_world = transform_points(pose, v_cam.reshape(-1, 3)).reshape(H, W, 3)
    n_cam = normal_map(v_cam)
    n_world = (n_cam.reshape(-1, 3) @ pose[:3, :3].T).reshape(H, W, 3)
    return RGBDFrame(
        color=color,
        depth=depth,
        intrinsics=intrinsics,
        pose=pose,
        vertices=v_world,
        normals=n_world,
        valid=(depth > 0).to(depth.dtype),
    )
