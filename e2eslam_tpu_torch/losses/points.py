"""3D point losses built on the exact KNN (``ops/knn.py``).

The chamferdist/pytorch3d convention of the reference
(``loss/losses.py:39-82``): nearest-neighbour indices are integral and
non-differentiable; distances are recomputed by gathering ``ref[idx]`` so
gradients flow to both clouds, and callers detach the cloud they want
frozen (the reference detaches the global map).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from e2eslam_tpu_torch.ops.knn import knn

Tensor = torch.Tensor


def _masked_mean(x: Tensor, n: Optional[int]) -> Tensor:
    if n is None:
        return x.mean()
    w = (torch.arange(x.shape[0], device=x.device) < n).to(x.dtype)
    return (x * w).sum() / max(float(n), 1.0)


def knn_points_loss(
    gt_points: Tensor,
    query_points: Tensor,
    *,
    n_gt=None,
    n_query=None,
    init_idx=None,
    q_perm=None,
) -> Tuple[Tensor, Tensor]:
    """Mean squared distance from each query point to its NN in ``gt_points``.

    The reference's argument order: gt first, query second (the search runs
    FROM query TO gt). ``n_gt``/``n_query`` are valid counts of
    fixed-capacity buffers; ``init_idx`` warm-start candidates and
    ``q_perm`` a query permutation, both passed to ``knn`` (exact either
    way). Returns (loss, nn indices ``[Nq]`` int32).
    """
    _, idx = knn(query_points.detach(), gt_points.detach(), n_gt, n_query,
                 init_idx=init_idx, q_perm=q_perm)
    nn_pts = gt_points[idx]
    d2 = ((query_points - nn_pts) ** 2).sum(dim=-1)
    return _masked_mean(d2, n_query), idx


def color_points_loss(gt_colors: Tensor, query_colors: Tensor, indexes: Tensor, *,
                      n_query=None) -> Tensor:
    """L1 between query-point colours and the colours of their NNs in gt.
    The absolute value's gradient at 0 is 1, as ``jnp.abs``'s (torch's is
    0): a query row whose colour equals its neighbour's still pulls on it."""
    d = query_colors - gt_colors[indexes]
    err = torch.where(d >= 0, d, -d).mean(dim=-1)
    return _masked_mean(err, n_query)


def _box3(x: Tensor) -> Tensor:
    """3x3 box filter with edge padding. ``x``: [H, W, C]."""
    xp = F.pad(x.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate")[0].permute(1, 2, 0)
    return (
        xp[:-2, :-2] + xp[:-2, 1:-1] + xp[:-2, 2:]
        + xp[1:-1, :-2] + xp[1:-1, 1:-1] + xp[1:-1, 2:]
        + xp[2:, :-2] + xp[2:, 1:-1] + xp[2:, 2:]
    ) * (1.0 / 9.0)


def _grad_mag(s: Tensor) -> Tensor:
    """Channel-mean |d/dx| + |d/dy| of ``s [H, W, C]``, edge-padded back to
    [H, W] (x repeats its last column, y its first row)."""
    gx = (s[:, 1:, :] - s[:, :-1, :]).abs().mean(dim=-1)
    gy = (s[1:, :, :] - s[:-1, :, :]).abs().mean(dim=-1)
    gx = torch.cat([gx, gx[:, -1:]], dim=1)
    gy = torch.cat([gy[:1], gy], dim=0)
    return gx + gy


# The blurred-gradient ratio E[g_coarse] / E[g_fine] of iid Gaussian pixel
# noise is 0.358 whatever its sigma, so subtracting 0.45 g_fine cancels the
# noise floor while scene edges (ratio ~0.85) survive
# (e2eslam_tpu/losses/points.py:114-119).
_NOISE_ALPHA = 0.45


def texture_gate(img: Tensor, k: float) -> Tensor:
    """Per-pixel gate ``exp(-k_eff * texture)`` ``[H*W]`` for the 3D point
    residuals (``LOSS.three3d_texture_gate``): 1 on flat regions, towards 0
    near texture. ``texture`` is a noise-cancelling band-pass score, the
    gradient magnitude of ``img [H, W, 3]`` blurred by 2 and by 6 box passes,
    ``max(g_coarse - 0.45 g_fine, 0)``, then box-filtered once more. ``k`` is
    defined at the reference's 320-pixel width and scaled by ``W / 320``
    (e2eslam_tpu/losses/points.py:122-167)."""
    s = _box3(_box3(img.float()))
    g_fine = _grad_mag(s)
    for _ in range(4):
        s = _box3(s)
    g_coarse = _grad_mag(s)
    band = (g_coarse - _NOISE_ALPHA * g_fine).clamp(min=0.0)
    band = _box3(band[..., None])[..., 0]
    k_eff = float(k) * (img.shape[1] / 320.0)
    return torch.exp(-k_eff * band).reshape(-1)


def chamfer_distance(a: Tensor, b: Tensor, *, n_a=None, n_b=None,
                     bidirectional: bool = True) -> Tensor:
    """(Half-)chamfer distance: ``dir(a->b) + dir(b->a)`` (chamferdist's
    definition; the reference applies its own 0.5, ``train_depth.py:690-692``),
    or ``dir(a->b)`` alone."""
    loss_ab, _ = knn_points_loss(b, a, n_gt=n_b, n_query=n_a)
    if not bidirectional:
        return loss_ab
    loss_ba, _ = knn_points_loss(a, b, n_gt=n_a, n_query=n_b)
    return loss_ab + loss_ba
