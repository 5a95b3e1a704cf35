"""The PointFusion SLAM front end (``odom: gt``).

The reference's incremental ``slam.step(map, live_frame, prev_frame)``
(``online_adaption.py:354-363``): localise the live frame, then fuse it.
Only ground-truth odometry is ported; gradICP/ICP come with slice 3.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from e2eslam_tpu_torch.slam.fusion import pointfusion_step
from e2eslam_tpu_torch.slam.pointclouds import MapState
from e2eslam_tpu_torch.slam.rgbd import RGBDFrame


@dataclasses.dataclass(frozen=True)
class PointFusion:
    """PointFusion SLAM (hyperparameters from ``MODEL.*``)."""

    odom: str = "gt"
    dist_th: float = 0.05
    angle_th: float = 20.0
    sigma: float = 0.6

    def __post_init__(self):
        if self.odom != "gt":
            raise NotImplementedError(
                f"MODEL.odom {self.odom!r}: only 'gt' is ported; ICP/gradICP "
                "odometry comes with slice 3 of the port"
            )

    def _update_map(self, state: MapState, frame: RGBDFrame) -> MapState:
        return pointfusion_step(state, frame, dist_th=self.dist_th,
                                angle_th=self.angle_th, sigma=self.sigma)

    def step(self, state: MapState, live_frame: RGBDFrame,
             prev_frame: Optional[RGBDFrame] = None):
        """Localise the live frame (gt: its own pose) and fuse it.
        Returns (map, pose)."""
        return self._update_map(state, live_frame), live_frame.pose
