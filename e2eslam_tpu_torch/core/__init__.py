"""Core geometry: SE(3), intrinsics, projection, resampling, depth."""

from e2eslam_tpu_torch._exports import lazy

__all__, __getattr__ = lazy(__name__, {
    "se3_inverse": "se3",
    "se3_exp": "se3",
    "se3_log": "se3",
    "poses_to_transforms": "se3",
    "camera_center": "se3",
    "frame_distance": "se3",
    "transform_points": "se3",
    "inverse_intrinsics": "camera",
    "normalize_intrinsics": "camera",
    "scale_intrinsics": "camera",
    "make_intrinsics": "camera",
    "pixel_grid": "projection",
    "backproject": "projection",
    "project": "projection",
    "grid_sample": "sampling",
    "disp_to_depth": "depth",
    "scale_disp": "depth",
    "indoor_disp_to_depth": "depth",
    "scale_by_focal": "depth",
})
