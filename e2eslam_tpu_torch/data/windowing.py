"""Sequence windowing and pose transforms (numpy).

gradslam's dataset args: ``dilation`` = frames skipped between consecutive
extracted frames, ``stride`` = frames between window starts, ``start`` =
first eligible frame index.
"""

from __future__ import annotations

from typing import List

import numpy as np


def make_windows(
    num_frames: int, seqlen: int, dilation: int = 0, stride: int = 1, start: int = 0
) -> List[List[int]]:
    """All in-range frame-index windows (empty when the trajectory is too short)."""
    dilation = dilation or 0
    stride = stride or 1
    start = start or 0
    span = (seqlen - 1) * (dilation + 1) + 1
    return [
        [s + i * (dilation + 1) for i in range(seqlen)]
        for s in range(start, num_frames - span + 1, stride)
    ]


def poses_to_transforms_np(poses: np.ndarray) -> np.ndarray:
    """Relative transforms with identity in slot 0 (float64 math)."""
    poses64 = np.asarray(poses, np.float64)
    out = np.empty_like(poses64)
    out[0] = np.eye(4)
    for k in range(1, poses64.shape[0]):
        out[k] = np.linalg.inv(poses64[k - 1]) @ poses64[k]
    return out.astype(np.asarray(poses).dtype)
