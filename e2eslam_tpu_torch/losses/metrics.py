"""Depth evaluation metrics (abs_rel, sq_rel, rmse, rmse_log, delta<1.25^k).

The reference (``loss/losses.py:162-201``), including the TUM convention of
masking zero-depth ground truth, as weighted means over a validity mask.
"""

from __future__ import annotations

from typing import Dict

import torch

Tensor = torch.Tensor


def compute_depth_errors(gt: Tensor, pred: Tensor, valid: Tensor) -> Dict[str, Tensor]:
    """Weighted error metrics over pixels where ``valid > 0``."""
    gt = gt.reshape(-1)
    pred = pred.reshape(-1)
    w = valid.reshape(-1).float()
    n = w.sum().clamp(min=1.0)

    def wmean(x):
        return (x * w).sum() / n

    safe_gt = torch.where(w > 0, gt, torch.ones_like(gt))
    safe_pred = torch.where(w > 0, pred, torch.ones_like(pred))
    thresh = torch.maximum(safe_gt / safe_pred, safe_pred / safe_gt)
    return {
        "abs_rel": wmean((safe_gt - safe_pred).abs() / safe_gt),
        "sq_rel": wmean((safe_gt - safe_pred) ** 2 / safe_gt),
        "rmse": wmean((safe_gt - safe_pred) ** 2).sqrt(),
        "rmse_log": wmean((safe_gt.log() - safe_pred.log()) ** 2).sqrt(),
        "a1": wmean((thresh < 1.25).float()),
        "a2": wmean((thresh < 1.25**2).float()),
        "a3": wmean((thresh < 1.25**3).float()),
    }


def depth_metrics(dataset: str, gt: Tensor, pred: Tensor) -> Dict[str, Tensor]:
    """Dataset-aware metrics: TUM masks zero-depth GT; ICL/synthetic use all."""
    if dataset == "TUM":
        valid = (gt != 0.0).float()
    elif dataset in ("ICL", "synthetic"):
        valid = torch.ones_like(gt)
    else:
        raise ValueError("Dataset Not Found")
    return compute_depth_errors(gt, pred, valid)
