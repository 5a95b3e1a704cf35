"""PointFusion: confidence-weighted surfel fusion into the fixed-capacity map.

gradslam's PointFusion step (the reference's ``models["SLAM"].step``,
``online_adaption.py:354-363``), as the JAX package's scatter fusion:

  1. project every valid map point into the live camera; candidates land
     in-frustum on a pixel with valid live depth;
  2. a candidate is *similar* if its distance to that pixel's live vertex
     is below ``dist_th`` and its normal within ``angle_th`` of the live
     normal;
  3. per pixel the closest similar candidate wins (scatter-min on
     distance, then scatter-min on index: the lowest index wins a tie);
  4. winners take a confidence-weighted average with the live measurement,
     whose confidence is a Gaussian of the normalised pixel radius;
  5. live pixels no winner claimed are appended at the ``count`` cursor.

The port runs fusion outside autograd and updates the map buffer in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from e2eslam_tpu_torch.core.se3 import se3_inverse, transform_points
from e2eslam_tpu_torch.slam.pointclouds import MapState, pack_rows
from e2eslam_tpu_torch.slam.rgbd import RGBDFrame

Tensor = torch.Tensor


class FramePoints(NamedTuple):
    """A frame's pixels as a flat (masked) point set [H*W, ...]."""

    points: Tensor  # [HW, 3] world frame
    normals: Tensor  # [HW, 3]
    colors: Tensor  # [HW, 3]
    mask: Tensor  # [HW] float validity


def frame_pointcloud(frame: RGBDFrame) -> FramePoints:
    """Flatten a frame into a masked point set."""
    HW = frame.depth.shape[0] * frame.depth.shape[1]
    return FramePoints(
        points=frame.vertices.reshape(HW, 3),
        normals=frame.normals.reshape(HW, 3),
        colors=frame.color.reshape(HW, 3),
        mask=frame.valid.reshape(HW),
    )


def _pixel_alpha(H: int, W: int, intrinsics: Tensor, sigma: float) -> Tensor:
    """Per-pixel measurement confidence: Gaussian in normalised pixel radius."""
    cx = intrinsics[0, 2]
    cy = intrinsics[1, 2]
    dev = intrinsics.device
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    gamma2 = ((xs - cx) ** 2 + (ys - cy) ** 2) / (cx**2 + cy**2 + 1e-12)
    return torch.exp(-gamma2 / (2.0 * sigma**2)).reshape(-1)


def _project_uv(points: Tensor, pose: Tensor, intrinsics: Tensor, H: int, W: int):
    """Project world points into a camera. Returns (ui, vi, in_frame)."""
    K = intrinsics
    p_cam = transform_points(se3_inverse(pose), points)
    z = p_cam[:, 2]
    safe_z = torch.where(z.abs() > 1e-8, z, torch.full_like(z, 1e-8))
    u = K[0, 0] * p_cam[:, 0] / safe_z + K[0, 2]
    v = K[1, 1] * p_cam[:, 1] / safe_z + K[1, 2]
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    in_frame = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & (z > 0)
    return ui, vi, in_frame


def _project_pixels(points: Tensor, pose: Tensor, intrinsics: Tensor, H: int, W: int):
    """Project world points into a camera. Returns (pix [N], in_frame [N])."""
    ui, vi, in_frame = _project_uv(points, pose, intrinsics, H, W)
    pix = vi.clamp(0, H - 1) * W + ui.clamp(0, W - 1)
    return pix, in_frame


def _cos_deg(angle_deg: float) -> float:
    # float32 math, as the JAX package evaluates the gate's threshold (the
    # result is a float32 value, so comparing float32 tensors with it is exact).
    return float(torch.cos(torch.deg2rad(torch.tensor(float(angle_deg)))))


def _associate(state: MapState, frame: RGBDFrame, live: FramePoints, *,
               dist_th: float, angle_th: float):
    """Project map points into the frame and rank them per pixel.

    Returns (pix [N], winner [N], v_live [N, 3], n_live [N, 3]): each map
    point's target pixel, the winner mask (one winner per pixel: the
    closest similar point, then the lowest index), and the live vertex and
    normal at each point's pixel.
    """
    H, W = frame.depth.shape[:2]
    HW = H * W
    N = state.data.shape[0]
    dev = state.data.device
    pix, in_frame = _project_pixels(state.points, frame.pose, frame.intrinsics, H, W)
    rows = torch.arange(N, device=dev)
    in_frame = in_frame & (rows < state.count)

    v_live = live.points[pix]
    n_live = live.normals[pix]
    dist = torch.linalg.norm(state.points - v_live, dim=-1)
    ndot = (state.normals * n_live).sum(dim=-1)
    similar = (in_frame & (live.mask[pix] > 0) & (dist < dist_th)
               & (ndot > _cos_deg(angle_th)))

    dist_m = torch.where(similar, dist, float("inf"))
    best_dist = torch.full((HW,), float("inf"), device=dev).scatter_reduce(
        0, pix, dist_m, "amin", include_self=True)
    is_best = similar & (dist_m <= best_dist[pix])
    idx_m = torch.where(is_best, rows, torch.full_like(rows, N))
    best_idx = torch.full((HW,), N, dtype=torch.int64, device=dev).scatter_reduce(
        0, pix, idx_m, "amin", include_self=True)
    winner = is_best & (rows == best_idx[pix])
    return pix, winner, v_live, n_live


@torch.no_grad()
def pointfusion_step(state: MapState, frame: RGBDFrame, *, dist_th: float = 0.05,
                     angle_th: float = 20.0, sigma: float = 0.6) -> MapState:
    """Fuse one live frame into the map, in place. Returns the new state
    (the same buffer, with the new count)."""
    H, W = frame.depth.shape[:2]
    HW = H * W
    N = state.data.shape[0]
    live = frame_pointcloud(frame)
    alpha = _pixel_alpha(H, W, frame.intrinsics, sigma) * live.mask

    pix, winner, v_live, n_live = _associate(
        state, frame, live, dist_th=dist_th, angle_th=angle_th)

    # ---- confidence-weighted fusion of the winners ----------------------
    a = alpha[pix]
    c = state.confidence
    wsum = (c + a).clamp(min=1e-12)
    wf = winner[:, None].to(state.data.dtype)

    def fuse(old, new):
        fused = (c[:, None] * old + a[:, None] * new) / wsum[:, None]
        return old + wf * (fused - old)

    points_w = fuse(state.points, v_live)
    colors_w = fuse(state.colors, live.colors[pix])
    normals_raw = fuse(state.normals, n_live)
    n2 = (normals_raw * normals_raw).sum(dim=-1, keepdim=True)
    ok_n = n2 > 1e-24
    normals_w = torch.where(
        ok_n, normals_raw / torch.where(ok_n, n2, torch.ones_like(n2)).sqrt(),
        normals_raw)
    confidence_w = c + winner.to(c.dtype) * a
    state.data.copy_(pack_rows(points_w, normals_w, colors_w, confidence_w))

    # ---- append the live pixels no winner claimed -----------------------
    claimed = torch.zeros(HW, dtype=torch.int64, device=pix.device).scatter_reduce(
        0, pix, winner.to(torch.int64), "amax", include_self=True)
    new_mask = (live.mask > 0) & (claimed == 0)
    order = torch.cumsum(new_mask.to(torch.int64), 0) - 1
    dest = state.count + order
    ok = new_mask & (dest < N)
    live_rows = pack_rows(live.points, live.normals, live.colors, alpha)
    state.data[dest[ok]] = live_rows[ok]
    count = min(state.count + int(new_mask.sum()), N)
    return MapState(data=state.data, count=count)
