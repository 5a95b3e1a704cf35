"""Losses: SSIM+L1 photometric, 3D point loss, depth metrics, trajectory errors."""

from e2eslam_tpu_torch._exports import lazy

__all__, __getattr__ = lazy(__name__, {
    "ssim": "photometric",
    "photometric_loss": "photometric",
    "disparity_smoothness_loss": "regularizers",
    "geometric_consistency_loss": "regularizers",
    "depth_regularizer": "regularizers",
    "depth_gt_loss": "regularizers",
    "sparse_sampling": "regularizers",
    "knn_points_loss": "points",
    "color_points_loss": "points",
    "chamfer_distance": "points",
    "knn_points_loss_map_sharded": "points_sharded",
    "chamfer_distance_map_sharded": "points_sharded",
    "nn_map_sharded": "points_sharded",
    "depth_metrics": "metrics",
    "compute_depth_errors": "metrics",
    "absolute_trajectory_error": "trajectory",
    "relative_pose_error": "trajectory",
})
