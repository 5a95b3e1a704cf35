"""Photometric reconstruction loss: SSIM + L1 (NHWC at the boundary).

The reference (``loss/losses.py:6-37`` and ``:97-117``): 3x3 average-pool
SSIM over reflection-padded inputs with ``C1 = 0.01^2, C2 = 0.03^2``,
clamped ``(1 - SSIM) / 2`` to [0, 1]; the map is ``0.85 * ssim + 0.15 *
L1``, channel-averaged, per pixel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

C1 = 0.01**2
C2 = 0.03**2
SSIM_WEIGHT = 0.85
L1_WEIGHT = 0.15


def ssim(x: Tensor, y: Tensor) -> Tensor:
    """Per-pixel SSIM dissimilarity map in [0, 1]; NHWC in and out."""
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    yp = F.pad(y.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    mu_x = F.avg_pool2d(xp, 3, 1)
    mu_y = F.avg_pool2d(yp, 3, 1)
    sigma_x = F.avg_pool2d(xp * xp, 3, 1) - mu_x * mu_x
    sigma_y = F.avg_pool2d(yp * yp, 3, 1) - mu_y * mu_y
    sigma_xy = F.avg_pool2d(xp * yp, 3, 1) - mu_x * mu_y
    num = (2.0 * mu_x * mu_y + C1) * (2.0 * sigma_xy + C2)
    den = (mu_x * mu_x + mu_y * mu_y + C1) * (sigma_x + sigma_y + C2)
    return torch.clamp((1.0 - num / den) / 2.0, 0.0, 1.0).permute(0, 2, 3, 1)


def photometric_loss(prediction: Tensor, target: Tensor) -> Tensor:
    """Per-pixel reprojection error ``[B, H, W, 1]``:
    ``0.85 * mean_c(SSIM) + 0.15 * mean_c(|target - prediction|)``."""
    ssim_map = ssim(prediction, target).mean(dim=-1, keepdim=True)
    l1_map = (target - prediction).abs().mean(dim=-1, keepdim=True)
    return SSIM_WEIGHT * ssim_map + L1_WEIGHT * l1_map
