"""RGB-D frame geometry, the packed map, PointFusion."""

from e2eslam_tpu_torch._exports import lazy

__all__, __getattr__ = lazy(__name__, {
    "RGBDFrame": "rgbd",
    "vertex_map": "rgbd",
    "normal_map": "rgbd",
    "build_frame": "rgbd",
    "MapState": "pointclouds",
    "empty_map": "pointclouds",
    "map_points": "pointclouds",
    "pointfusion_step": "fusion",
    "frame_pointcloud": "fusion",
    "projective_nn": "fusion",
    "gradicp": "odometry",
    "point_to_plane_icp": "odometry",
    "PointFusion": "slam",
    "ICPSLAM": "slam",
})
