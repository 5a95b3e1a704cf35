"""SLAM front ends: PointFusion and ICPSLAM, step by step or over a sequence.

The port of ``e2eslam_tpu/slam/slam.py``: the reference's incremental
``slam.step(map, live_frame, prev_frame)`` (``online_adaption.py:354-363``)
localises the live frame (its own pose with ``odom: gt``; gradICP or
Gauss-Newton ICP against the previous frame otherwise), rebuilds it at the
estimated pose and fuses it, by scatter fusion (optionally within an
active window of the newest map rows) or through the cached index images.
``PointFusion.__call__`` reconstructs a whole sequence, as the reference's
``slam(sequence)`` (``train_depth.py:373-385``). ICPSLAM appends every
valid pixel instead of fusing.

Fusion updates the map buffer in place outside autograd; ``__call__``
under autograd, with depths or colours that require grad, carries the
gradient to them through every fusion (``slam/fusion.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from e2eslam_tpu_torch.slam.fusion import (
    _write_rows,
    count_add,
    frame_pointcloud,
    pointfusion_step,
    pointfusion_step_index,
)
from e2eslam_tpu_torch.slam.odometry import gradicp
from e2eslam_tpu_torch.slam.pointclouds import MapState, empty_map, pack_rows
from e2eslam_tpu_torch.slam.rgbd import RGBDFrame, build_frame

Tensor = torch.Tensor

ODOMETRY = ("gt", "icp", "gradicp")


@torch.no_grad()
def _append_frame(state: MapState, frame: RGBDFrame,
                  active: Optional[Tensor] = None) -> MapState:
    """ICPSLAM's map update: append every valid pixel at the count cursor,
    in place (``e2eslam_tpu/slam/slam.py:34-51``); the count an int or a
    device tensor, as fusion's, and ``active`` as fusion's."""
    live = frame_pointcloud(frame)
    N = state.data.shape[0]
    new_mask = live.mask > 0
    if active is not None:
        new_mask = new_mask & active
    dest = state.count + torch.cumsum(new_mask.to(torch.int64), 0) - 1
    ok = new_mask & (dest < N)
    rows = pack_rows(live.points, live.normals, live.colors, live.mask)
    _write_rows(state.data, dest, rows, ok)
    return dataclasses.replace(state, count=count_add(state.count, new_mask.sum(), N))


@dataclasses.dataclass(frozen=True)
class PointFusion:
    """PointFusion SLAM (hyperparameters from ``MODEL.*``)."""

    odom: str = "gradicp"  # gt | icp | gradicp
    dist_th: float = 0.05
    angle_th: float = 20.0
    sigma: float = 0.6
    numiters: int = 20
    icp_dist_th: float = 0.2
    icp_downsample: int = 4
    # Scatter fusion associates with the newest W map rows only.
    active_window: Optional[int] = None
    fusion_impl: str = "scatter"  # scatter | index
    index_levels: int = 1  # index fusion: 1 or 2 cached keyframe index images
    # Level 2's refresh period: 1 = the previous keyframe; K > 1 = every
    # K-th keyframe's image, held K keyframes.
    index_level2_period: int = 1
    # Index fusion probes the (2r+1)^2 pixels around each projection.
    index_search_radius: int = 0

    def __post_init__(self):
        if self.odom not in ODOMETRY:
            raise ValueError(f"MODEL.odom {self.odom!r}: one of {ODOMETRY}")

    def _update_map(self, state: MapState, frame: RGBDFrame,
                    active: Optional[Tensor] = None) -> MapState:
        """Fuse ``frame``; where ``active`` (a 0-d bool tensor) is False the
        map is left as it was (``slam/fusion.py``)."""
        if self.fusion_impl == "index":
            return pointfusion_step_index(
                state, frame, dist_th=self.dist_th, angle_th=self.angle_th,
                sigma=self.sigma, level2_period=self.index_level2_period,
                search_radius=self.index_search_radius, active=active)
        return pointfusion_step(state, frame, dist_th=self.dist_th, angle_th=self.angle_th,
                                sigma=self.sigma, active_window=self.active_window,
                                active=active)

    def _localize(self, live: RGBDFrame, prev: Optional[RGBDFrame]) -> Tensor:
        """The live frame's world pose (``slam.py:99-110``)."""
        if self.odom == "gt" or prev is None:
            return live.pose
        return gradicp(live, prev, numiters=self.numiters, dist_th=self.icp_dist_th,
                       downsample=self.icp_downsample, soft=self.odom == "gradicp")

    def step(self, state: MapState, live_frame: RGBDFrame,
             prev_frame: Optional[RGBDFrame] = None, active: Optional[Tensor] = None):
        """Localise the live frame (unless ``prev_frame`` is None) and fuse
        it (where ``active``, as ``_update_map``). Returns (map, pose,
        frame), ``frame`` the one fused: with estimated odometry, rebuilt at
        the estimated pose (``slam.py:112-136``), so its world vertices, and
        on the index path the cached ``index_pose``, agree with that pose."""
        pose = self._localize(live_frame, prev_frame)
        if self.odom != "gt" and prev_frame is not None:
            live_frame = build_frame(live_frame.color, live_frame.depth,
                                     live_frame.intrinsics, pose)
        return self._update_map(state, live_frame, active), pose, live_frame

    def __call__(self, colors: Tensor, depths: Tensor, intrinsics: Tensor, poses: Tensor, *,
                 capacity: Optional[int] = None,
                 detach_poses: bool = False) -> Tuple[MapState, Tensor]:
        """Whole-sequence reconstruction of ``[L, H, W, ...]`` frames
        (``slam.py:138-186``, a ``lax.scan`` there). ``poses`` are the
        dataset's (frame 0's anchors the trajectory; with ``odom: gt`` each
        frame's is used). ``detach_poses`` cuts the pose chain's gradients
        between steps. Returns (map, poses [L, 4, 4])."""
        L, H, W = colors.shape[:3]
        state = empty_map(L * H * W if capacity is None else capacity, device=colors.device,
                          index_hw=H * W if self.fusion_impl == "index" else None,
                          index_levels=self.index_levels)
        prev = build_frame(colors[0], depths[0], intrinsics, poses[0])
        state = self._update_map(state, prev)
        est = [poses[0]]
        for i in range(1, L):
            live = build_frame(colors[i], depths[i], intrinsics, poses[i])
            state, pose, prev = self.step(state, live, prev)
            if detach_poses:
                prev = prev._replace(pose=prev.pose.detach())
            est.append(pose)
        return state, torch.stack(est)


@dataclasses.dataclass(frozen=True)
class ICPSLAM(PointFusion):
    """Odometry and raw map concatenation (gradslam's ICPSLAM). Its map
    update takes ``PointFusion._update_map``'s arguments; the JAX class's
    override does not, and its ``step`` raises (``slam.py:133``, ``:193``)."""

    def _update_map(self, state: MapState, frame: RGBDFrame,
                    active: Optional[Tensor] = None) -> MapState:
        return _append_frame(state, frame, active)
