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
