"""Disparity -> depth conversions (reference ``utils/training_utils.py:106-140``)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def disp_to_depth(disp: Tensor, min_depth: float, max_depth: float) -> Tensor:
    """monodepth2 disparity -> depth: sigmoid output mapped into
    ``[1/max_depth, 1/min_depth]``, then inverted."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    return 1.0 / (min_disp + (max_disp - min_disp) * disp)


def indoor_disp_to_depth(disp: Tensor) -> Tensor:
    """Indoor network disparity -> depth (plain inversion)."""
    return 1.0 / disp
