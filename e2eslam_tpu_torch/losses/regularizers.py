"""Depth/disparity regularizers and weak supervision (NHWC).

The counterparts of ``e2eslam_tpu/losses/regularizers.py`` (reference
``loss/losses.py:84-160`` and the sparse sampler
``utils/training_utils.py:176-189``). Masked reductions are weighted means,
as in the JAX package. ``sparse_sampling`` draws from an explicit
``torch.Generator``: JAX's threefry stream has no torch counterpart, so the
samples match the JAX package's in distribution, not bit for bit.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def disparity_smoothness_loss(disp: Tensor, img: Tensor) -> Tensor:
    """Edge-aware first-order smoothness of (mean-normalised) disparity
    ``[B, H, W, 1]`` against image ``[B, H, W, 3]``."""
    grad_disp_x = (disp[:, :, :-1, :] - disp[:, :, 1:, :]).abs()
    grad_disp_y = (disp[:, :-1, :, :] - disp[:, 1:, :, :]).abs()
    grad_img_x = (img[:, :, :-1, :] - img[:, :, 1:, :]).abs().mean(dim=-1, keepdim=True)
    grad_img_y = (img[:, :-1, :, :] - img[:, 1:, :, :]).abs().mean(dim=-1, keepdim=True)
    return ((grad_disp_x * torch.exp(-grad_img_x)).mean()
            + (grad_disp_y * torch.exp(-grad_img_y)).mean())


def geometric_consistency_loss(warped_depth: Tensor, interpolated_depth: Tensor,
                               valid_mask: Tensor) -> Tensor:
    """``|Dw - Di| / (Dw + Di)`` clamped to [0, 1], masked mean; zero when
    10000 or fewer pixels are valid (the reference's guard, ``losses.py:90``)."""
    abs_diff = ((warped_depth - interpolated_depth).abs()
                / (warped_depth + interpolated_depth)).clamp(0.0, 1.0)
    mask = valid_mask.expand_as(abs_diff)
    mask_sum = mask.sum()
    mean_value = (abs_diff * mask).sum() / mask_sum.clamp(min=1.0)
    return torch.where(mask_sum > 10000, mean_value, torch.zeros_like(mean_value))


def depth_regularizer(initial_depth: Tensor, refined_depth: Tensor,
                      loss_func: str = "l2") -> Tensor:
    """Keeps fine-tuning from drifting off the initial prediction."""
    diff = refined_depth - initial_depth.detach()
    if loss_func == "l1":
        return diff.abs().mean()
    if loss_func == "l2":
        return (diff * diff).mean()
    raise ValueError("please specify a correct norm")


def depth_gt_loss(prediction: Tensor, sparse_groundtruth: Tensor,
                  sparse_mask: Tensor) -> Tensor:
    """L1 against sparsely sampled ground-truth depth, averaged over ALL
    pixels (reference parity, ``losses.py:151-160``: the sampling
    probability acts as an implicit weight)."""
    pred = prediction.reshape(prediction.shape[0], -1)
    gt = sparse_groundtruth.reshape(sparse_groundtruth.shape[0], -1)
    mask = sparse_mask.reshape(sparse_mask.shape[0], -1)
    return (pred * mask - gt).abs().mean()


def sparse_sampling(generator: torch.Generator, depth: Tensor, prob: float,
                    sampling_type: str = "random"):
    """Random sparse depth sampling: each pixel with probability ``prob``,
    never one of zero depth. Returns (masked depth, mask)."""
    if sampling_type != "random":
        raise ValueError("Sampling type not implemented")
    u = torch.rand(depth.shape, generator=generator, dtype=depth.dtype, device=depth.device)
    mask = ((u < prob) & (depth != 0.0)).to(depth.dtype)
    return depth * mask, mask
