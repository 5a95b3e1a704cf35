"""Point-cloud export: ASCII PLY files always, plotly figures when plotly
imports.

The port of ``e2eslam_tpu/viz/pointcloud_export.py`` (the reference's
``global_pointcloud.plotly(0, ...).show()``, ``online_adaption.py:252``).
A map's valid rows come to the host once; a subsample draws from
``np.random.default_rng(0)``, as the JAX package does, so the same map gives
the same file.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from e2eslam_tpu_torch.slam.pointclouds import MapState


def map_to_arrays(state: MapState, max_points: Optional[int] = None):
    """The map's valid points and colours (clipped to [0, 1]) as host numpy
    arrays, subsampled to ``max_points``."""
    n = int(state.count)
    data = state.data[:n]
    data = data.detach().cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)
    pts, colors = data[:, 0:3], np.clip(data[:, 6:9], 0.0, 1.0)
    if max_points and n > max_points:
        idx = np.random.default_rng(0).choice(n, max_points, replace=False)
        pts, colors = pts[idx], colors[idx]
    return pts, colors


def export_ply(state: MapState, path: str, max_points: Optional[int] = None) -> str:
    """Write the map as an ASCII PLY with vertex colours."""
    pts, colors = map_to_arrays(state, max_points)
    rgb = (colors * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        cols = np.concatenate([np.asarray(pts, np.float64).round(5), rgb.astype(np.int64)],
                              axis=1)
        f.write("\n".join("%.5f %.5f %.5f %d %d %d" % tuple(row) for row in cols))
        if len(cols):
            f.write("\n")
    return path


def plotly_figure(state: MapState, max_points: int = 50000, point_size: int = 2):
    """A 3D scatter of the map; None when plotly does not import."""
    try:
        import plotly.graph_objects as go
    except ImportError:
        return None
    pts, colors = map_to_arrays(state, max_points)
    rgb = (colors * 255).astype(np.uint8)
    fig = go.Figure(data=[go.Scatter3d(
        x=pts[:, 0], y=pts[:, 1], z=pts[:, 2], mode="markers",
        marker=dict(size=point_size, color=[f"rgb({r},{g},{b})" for r, g, b in rgb]))])
    fig.update_layout(scene=dict(aspectmode="data"))
    return fig
