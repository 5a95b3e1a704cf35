"""Observability: point-cloud export, the map-update animation, scalar
logging, gradient histograms and debug images."""

from e2eslam_tpu_torch._exports import lazy

__all__, __getattr__ = lazy(__name__, {
    "export_ply": "pointcloud_export",
    "map_to_arrays": "pointcloud_export",
    "plotly_figure": "pointcloud_export",
    "ScalarLogger": "logging",
    "gradient_histograms": "logging",
})
