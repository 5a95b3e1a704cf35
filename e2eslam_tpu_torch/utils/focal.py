"""Focal-length averaging.

The port's copy of ``e2eslam_tpu/utils/focal.py`` (the reference's
``utils/pretrained_focal.py``, which derives ``ABLATION.focal_pretrain =
285.8`` by averaging fx and fy over the NYU scenes' intrinsics): average the
focal terms of a set of intrinsics matrices, optionally read from per-scene
text files.
"""

from __future__ import annotations

import glob
import os
from typing import Iterable

import numpy as np


def average_focal(intrinsics: Iterable[np.ndarray]) -> float:
    """Mean of (fx + fy) / 2 over a collection of [>=3, >=3] K matrices."""
    focals = [(np.asarray(K)[0, 0] + np.asarray(K)[1, 1]) / 2.0 for K in intrinsics]
    if not focals:
        raise ValueError("no intrinsics given")
    return float(np.mean(focals))


def average_focal_from_dir(path: str, pattern: str = "*.txt") -> float:
    """Average focal over whitespace-separated 3x3 (or 4x4) matrix files."""
    files = sorted(glob.glob(os.path.join(path, pattern)))
    mats = []
    for f in files:
        values = np.asarray(np.loadtxt(f), dtype=np.float64)
        # The top-left 3x3 of the matrix as laid out in the file (a 4x4's
        # first nine values, reshaped, would scramble its rows).
        if values.ndim == 2 and values.shape[0] >= 3 and values.shape[1] >= 3:
            mats.append(values[:3, :3])
        elif values.ndim == 1:
            side = int(np.sqrt(values.size))
            if side >= 3 and side * side == values.size:
                mats.append(values.reshape(side, side)[:3, :3])
    if not mats:
        raise FileNotFoundError(f"no intrinsics files matching {pattern} under {path}")
    return average_focal(mats)
