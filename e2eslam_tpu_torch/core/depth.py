"""Disparity -> depth conversions (reference ``utils/training_utils.py:106-140``)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def scale_disp(disp: Tensor, min_depth: float, max_depth: float) -> Tensor:
    """Map a sigmoid output into the disparity range ``[1/max_depth, 1/min_depth]``."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    return min_disp + (max_disp - min_disp) * disp


def disp_to_depth(disp: Tensor, min_depth: float, max_depth: float) -> Tensor:
    """monodepth2 disparity -> depth: ``scale_disp``, then inverted."""
    return 1.0 / scale_disp(disp, min_depth, max_depth)


def indoor_disp_to_depth(disp: Tensor) -> Tensor:
    """Indoor network disparity -> depth (plain inversion)."""
    return 1.0 / disp


def scale_by_focal(depth: Tensor, focal_data, focal_pretrain: float) -> Tensor:
    """Depth rescaled by a focal-length ratio (CNN-SLAM's rule,
    ``training_utils.py:142-152``): ``depth * (focal_data /
    focal_pretrain)``; ``focal_data`` a number or a 0-d tensor."""
    return depth * (focal_data / focal_pretrain)
