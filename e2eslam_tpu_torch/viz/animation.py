"""Animated map-update visualization (plotly-free).

The port's copy of ``e2eslam_tpu/viz/animation.py``: it reproduces the
payload of the reference's ``plotly_map_update_visualization``
(``utils/advanced_vis.py:7-170``): per-keyframe frames each holding the
camera frustum polyline, the camera-center marker, the trajectory polyline
and the fused point cloud, with a slider + play/stop controls.

plotly (the Python package) is not a dependency: the figure is built as a
plain plotly-schema ``dict`` and serialized into a self-contained HTML file
that loads ``plotly.js`` from the CDN. The same dict renders with
``plotly.graph_objects.Figure(fig_dict)`` when plotly IS installed.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence

import numpy as np


def _frustum_vertices(intrinsics: np.ndarray) -> np.ndarray:
    """The 10-vertex frustum polyline in camera frame (reference layout,
    ``advanced_vis.py:40-57``): image-plane corners at focal depth, with
    edges back to the camera center woven in so one line trace draws the
    whole wireframe."""
    K = np.asarray(intrinsics, np.float64)
    f = (abs(K[0, 0]) + abs(K[1, 1])) / 2.0
    cx = K[0, 2] / f
    cy = K[1, 2] / f
    o = [0.0, 0.0, 0.0]
    return np.array(
        [
            [-cx, -cy, 1.0],
            [cx, -cy, 1.0],
            o,
            [-cx, -cy, 1.0],
            [-cx, cy, 1.0],
            o,
            [cx, cy, 1.0],
            [-cx, cy, 1.0],
            [cx, cy, 1.0],
            [cx, -cy, 1.0],
        ]
    )


def _line_trace(xyz: np.ndarray, width: int, color: str = "purple") -> dict:
    return {
        "type": "scatter3d",
        "mode": "lines+markers",
        "x": xyz[:, 0].tolist(),
        "y": xyz[:, 1].tolist(),
        "z": xyz[:, 2].tolist(),
        "marker": {"size": 0.1},
        "line": {"color": color, "width": width},
    }


def camera_traces(
    poses: np.ndarray, intrinsics: np.ndarray, upto: int
) -> List[dict]:
    """Frustum + center marker + trajectory-so-far for keyframe ``upto``.

    Mirrors ``plotly_poses`` (``advanced_vis.py:23-101``): three traces per
    frame, trajectory accumulated over keyframes ``0..upto``.
    """
    poses = np.asarray(poses, np.float64)
    fr0 = _frustum_vertices(intrinsics)
    pose = poses[upto]
    rot, tvec = pose[:3, :3], pose[:3, 3]
    frustum = np.round(fr0 @ rot.T + tvec, 2)
    centers = np.round(poses[: upto + 1, :3, 3], 2)
    pos = centers[-1]
    return [
        _line_trace(frustum, width=4),
        {
            "type": "scatter3d",
            "mode": "markers",
            "x": [pos[0]],
            "y": [pos[1]],
            "z": [pos[2]],
            "marker": {"size": 6.0, "color": "purple"},
        },
        _line_trace(centers, width=2),
    ]


def _cloud_trace(
    points: np.ndarray,
    colors: np.ndarray,
    max_points: int,
    point_size: float = 1.5,
) -> dict:
    n = len(points)
    if n > max_points:
        idx = np.random.default_rng(0).choice(n, max_points, replace=False)
        points, colors = points[idx], colors[idx]
    rgb = (np.clip(colors, 0.0, 1.0) * 255).astype(np.uint8)
    return {
        "type": "scatter3d",
        "mode": "markers",
        "x": np.round(points[:, 0], 3).tolist(),
        "y": np.round(points[:, 1], 3).tolist(),
        "z": np.round(points[:, 2], 3).tolist(),
        "marker": {
            "size": point_size,
            "color": [f"rgb({r},{g},{b})" for r, g, b in rgb],
        },
    }


def _frame_args(duration_ms: int) -> dict:
    return {
        "frame": {"duration": duration_ms, "redraw": True},
        "mode": "immediate",
        "fromcurrent": True,
        "transition": {"duration": duration_ms, "easing": "linear"},
    }


def map_update_figure(
    snapshots: Sequence,
    poses: np.ndarray,
    intrinsics: np.ndarray,
    *,
    max_points_per_frame: int = 50000,
    ms_per_frame: int = 50,
) -> dict:
    """Build the animated figure dict (reference ``advanced_vis.py:112-170``).

    Args:
      snapshots: per-keyframe ``MapState``s (device or host) -- the map after
        each fusion, as collected by ``apps.demo.Demo``.
      poses: ``[K, 4, 4]`` keyframe camera poses (estimated or GT).
      intrinsics: ``[4, 4]`` (or ``[3, 3]``) camera intrinsics.
    """
    from e2eslam_tpu_torch.viz.pointcloud_export import map_to_arrays

    poses = np.asarray(poses, np.float64)
    frames = []
    for i, snap in enumerate(snapshots):
        pts, cols = map_to_arrays(snap, max_points_per_frame)
        traces = camera_traces(poses, intrinsics, min(i, len(poses) - 1))
        traces.append(_cloud_trace(pts, cols, max_points_per_frame))
        frames.append({"data": traces, "name": str(i)})

    steps = [
        {"args": [[f["name"]], _frame_args(0)], "label": str(i), "method": "animate"}
        for i, f in enumerate(frames)
    ]
    sliders = [
        {
            "active": 0,
            "yanchor": "top",
            "xanchor": "left",
            "currentvalue": {"prefix": "Frame: "},
            "pad": {"b": 10, "t": 60},
            "len": 0.9,
            "x": 0.1,
            "y": 0,
            "steps": steps,
        }
    ]
    updatemenus = [
        {
            "buttons": [
                {
                    "args": [None, _frame_args(ms_per_frame)],
                    "label": "&#9654;",
                    "method": "animate",
                },
                {
                    "args": [[None], _frame_args(0)],
                    "label": "&#9724;",
                    "method": "animate",
                },
            ],
            "direction": "left",
            "pad": {"r": 10, "t": 70},
            "showactive": False,
            "type": "buttons",
            "x": 0.1,
            "xanchor": "right",
            "y": 0,
            "yanchor": "top",
        }
    ]
    hidden_axis = {
        "showticklabels": False,
        "showgrid": False,
        "zeroline": False,
        "visible": False,
    }
    return {
        "data": frames[0]["data"] if frames else [],
        "frames": frames,
        "layout": {
            "updatemenus": updatemenus,
            "sliders": sliders,
            "showlegend": False,
            "scene": {
                "xaxis": hidden_axis,
                "yaxis": hidden_axis,
                "zaxis": hidden_axis,
                "aspectmode": "data",
            },
        },
    }


_HTML_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8"/>
<title>e2eslam_tpu_torch map update</title>
<script src="https://cdn.plot.ly/plotly-2.35.2.min.js"></script>
</head>
<body>
<div id="map" style="width:100vw;height:95vh;"></div>
<script id="figure-data" type="application/json">
{fig_json}
</script>
<script>
var fig = JSON.parse(document.getElementById("figure-data").textContent);
Plotly.newPlot("map", fig.data, fig.layout).then(function() {{
  Plotly.addFrames("map", fig.frames);
}});
</script>
</body>
</html>
"""


def write_animation_html(fig: dict, path: str) -> str:
    """Serialize the figure dict into a standalone HTML file.

    The JSON payload is embedded in a ``<script type="application/json">``
    block, so tests (and tools) can parse the exact figure back out of the
    file without plotly installed.
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(_HTML_TEMPLATE.format(fig_json=json.dumps(fig)))
    return path


def read_animation_html(path: str) -> dict:
    """Parse the figure dict back out of a ``write_animation_html`` file."""
    with open(path) as f:
        html = f.read()
    start = html.index('<script id="figure-data" type="application/json">')
    start = html.index("\n", start) + 1
    end = html.index("</script>", start)
    return json.loads(html[start:end])
