"""The PointFusion SLAM front end (``odom: gt``).

The reference's incremental ``slam.step(map, live_frame, prev_frame)``
(``online_adaption.py:354-363``): localise the live frame, then fuse it,
by scatter fusion or, with ``fusion_impl: index``, through the cached
index images (``e2eslam_tpu/slam/slam.py:54-98``). Only ground-truth
odometry is ported; gradICP/ICP come with slice 3.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from e2eslam_tpu_torch.slam.fusion import pointfusion_step, pointfusion_step_index
from e2eslam_tpu_torch.slam.pointclouds import MapState
from e2eslam_tpu_torch.slam.rgbd import RGBDFrame


@dataclasses.dataclass(frozen=True)
class PointFusion:
    """PointFusion SLAM (hyperparameters from ``MODEL.*``)."""

    odom: str = "gt"
    dist_th: float = 0.05
    angle_th: float = 20.0
    sigma: float = 0.6
    fusion_impl: str = "scatter"  # scatter | index
    index_levels: int = 1  # index fusion: 1 or 2 cached keyframe index images
    # Level 2's refresh period: 1 = the previous keyframe; K > 1 = every
    # K-th keyframe's image, held K keyframes.
    index_level2_period: int = 1
    # Index fusion probes the (2r+1)^2 pixels around each projection.
    index_search_radius: int = 0

    def __post_init__(self):
        if self.odom != "gt":
            raise NotImplementedError(
                f"MODEL.odom {self.odom!r}: only 'gt' is ported; ICP/gradICP "
                "odometry comes with slice 3 of the port"
            )

    def _update_map(self, state: MapState, frame: RGBDFrame) -> MapState:
        if self.fusion_impl == "index":
            return pointfusion_step_index(
                state, frame, dist_th=self.dist_th, angle_th=self.angle_th,
                sigma=self.sigma, level2_period=self.index_level2_period,
                search_radius=self.index_search_radius)
        return pointfusion_step(state, frame, dist_th=self.dist_th,
                                angle_th=self.angle_th, sigma=self.sigma)

    def step(self, state: MapState, live_frame: RGBDFrame,
             prev_frame: Optional[RGBDFrame] = None):
        """Localise the live frame (gt: its own pose) and fuse it.
        Returns (map, pose)."""
        return self._update_map(state, live_frame), live_frame.pose
