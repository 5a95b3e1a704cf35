"""3D point losses against a map whose rows are sharded across processes.

The port of ``e2eslam_tpu/losses/points_sharded.py`` on
``torch.distributed``: the same losses as ``losses/points.py`` when the
global map is cut into contiguous row shards, one per rank of a process
group (``ops/knn_sharded.py``), and the frame cloud (the queries, about
H*W points) is the same on every rank.

The map is a constant (the reference detaches it before the 3D loss,
``online_adaption.py:643``): gradients reach the frame cloud only.

  * frame->map: each query's winning map point is combined across shards
    and its distance recomputed on every rank; the backward touches no
    shard and runs no collective.
  * map->frame: each rank pairs its valid map rows with their nearest frame
    points and sums the distances; the partial sums leave through
    ``_FromShards`` (forward: an all-reduce; backward: the identity) and
    the frame enters through ``_ToShards`` (forward: the identity;
    backward: an all-reduce of the frame's gradient). So each rank's loss
    is the global sum and its frame gradient the sum of every shard's
    part. ``torch.distributed.nn.functional.all_reduce`` would instead
    all-reduce the gradient in its own backward, which multiplies the
    replicated frame's gradient by the group's size.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from e2eslam_tpu_torch.losses.points import _masked_mean
from e2eslam_tpu_torch.ops.knn import knn
from e2eslam_tpu_torch.ops.knn_sharded import knn_map_sharded

Tensor = torch.Tensor


class _ToShards(torch.autograd.Function):
    """A replicated tensor entering per-shard work: the identity forward,
    the gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _FromShards(torch.autograd.Function):
    """Per-shard partial sums leaving as their total: summed over the group
    forward, the gradient passed through backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def nn_map_sharded(group, query: Tensor, map_local: Tensor, aux_local: Optional[Tensor] = None,
                   *, n_map=None, n_query=None) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Nearest valid map point of each query, the map sharded over
    ``group``: ``(global indices [Nq] int32, winning points [Nq, 3],
    winning rows of ``aux_local``'s buffer [Nq, C] or None)``, detached and
    the same on every rank."""
    out = knn_map_sharded(group, query.detach(), map_local.detach(), n_map, n_query,
                          with_points=True,
                          aux=None if aux_local is None else aux_local.detach())
    win_aux = out[3] if aux_local is not None else None
    return out[1], out[2], win_aux


def knn_points_loss_map_sharded(group, map_local: Tensor, query_points: Tensor, *,
                                n_map=None, n_query=None) -> Tuple[Tensor, Tensor]:
    """``losses.points.knn_points_loss(map, query)`` with the map sharded:
    the mean squared distance of each valid query to its nearest valid map
    point, differentiable in ``query_points``. Returns (loss, global
    indices)."""
    idx, win_pts, _ = nn_map_sharded(group, query_points, map_local, n_map=n_map,
                                     n_query=n_query)
    d2 = ((query_points - win_pts) ** 2).sum(dim=-1)
    return _masked_mean(d2, n_query), idx


def chamfer_distance_map_sharded(group, frame: Tensor, map_local: Tensor, *, n_frame=None,
                                 n_map=None, bidirectional: bool = True) -> Tensor:
    """``losses.points.chamfer_distance(frame, map)`` with the map sharded
    and held constant: ``dir(frame->map) + dir(map->frame)`` (or the first
    alone), differentiable in ``frame``."""
    loss_fm, _ = knn_points_loss_map_sharded(group, map_local, frame, n_map=n_map,
                                             n_query=n_frame)
    if not bidirectional:
        return loss_fm
    D, k = dist.get_world_size(group), dist.get_rank(group)
    S = map_local.shape[0]
    nm = D * S if n_map is None else int(n_map)
    nf = frame.shape[0] if n_frame is None else int(n_frame)
    part = map_to_frame_sum(_ToShards.apply(frame, group), map_local,
                            min(max(nm - k * S, 0), S), nf)
    return loss_fm + _FromShards.apply(part, group) / max(float(nm), 1.0)


def map_to_frame_sum(frame: Tensor, map_local: Tensor, n_local: int, n_frame: int) -> Tensor:
    """One shard's part of the chamfer's map->frame direction: the sum,
    over its first ``n_local`` (valid) rows, of the squared distance to the
    nearest of the frame's first ``n_frame`` points; differentiable in
    ``frame``. The shard's rows query the frame (the frame is the ref set).
    A plain function, so one process can sum the parts of several shards."""
    m = map_local.detach()
    _, idx = knn(m, frame.detach(), n_frame, n_local)
    d2 = ((m - frame.index_select(0, idx.long())) ** 2).sum(dim=-1)
    valid = torch.arange(m.shape[0], device=m.device) < n_local
    return torch.where(valid, d2, torch.zeros_like(d2)).sum()
