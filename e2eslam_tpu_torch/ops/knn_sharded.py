"""Exact top-1 KNN over a map whose rows are sharded across processes.

The port of ``e2eslam_tpu/ops/knn_sharded.py`` on ``torch.distributed``:
the fixed-capacity map ``[capacity, 3]`` is cut into ``D`` contiguous
shards of ``S = capacity / D`` rows, shard ``k`` on rank ``k`` of a
process group. Valid rows are the prefix ``[0, nr)``, so shard ``k`` holds
``clip(nr - k*S, 0, S)`` of them. Every rank searches its own rows for the
whole (replicated) query set with the single-device exact search
(``ops/knn.py::knn``: the CUDA kernels on the card), and one ``all_gather``
of each query's ``(distance, global index[, payload])`` per shard feeds the
combine: the least distance wins, ties to the lowest shard (as
``jnp.argmin``). The payload (the winning row's coordinates, and rows of a
companion buffer such as the map's colours) is gathered on its shard before
the combine, so no shard's buffer travels whole.

The search and the combine are plain functions (``shard_search``,
``combine``): one process can run ``D`` shards in a loop, which is how a
single card checks them. Distances equal the unsharded search's; indices
too wherever the nearest neighbour is unique (the unsharded kernels break
exact ties toward the newest tile, the combine toward the lowest shard).
An empty shard (no valid row) still runs its search, whose every ref is
biased away; its distances are set to ``+inf`` and never read from the
kernel's output. The shard searches take no warm seeds
(``knn_sharded.py:95``), so a shard of at most ``RES_MAX_ROWS`` padded
rows takes the resident kernel and a larger one the dense kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from e2eslam_tpu_torch.ops.knn import knn

Tensor = torch.Tensor


def shard_size(rows: int, shards: int, axis: str = "map") -> int:
    """Rows per shard of a ``rows``-row buffer cut into ``shards``."""
    if rows % shards:
        raise ValueError(f"the '{axis}' axis size ({shards}) must divide ref rows ({rows})")
    return rows // shards


def shard_map_rows(ref: Tensor, group=None, *, axis: str = "map") -> Tensor:
    """This rank's contiguous row slice of ``ref [Nr, ...]`` over ``group``
    (the default group when None); the group's size must divide ``Nr``."""
    D, k = dist.get_world_size(group), dist.get_rank(group)
    S = shard_size(ref.shape[0], D, axis)
    return ref[k * S:(k + 1) * S]


def shard_search(query: Tensor, ref_local: Tensor, offset: int, nr: int, nq=None, *,
                 with_points: bool = False, aux_local: Optional[Tensor] = None):
    """One shard's search: ``query [Nq, 3]`` against its rows ``ref_local
    [S, 3]``, the global rows ``[offset, offset + S)``, of which those
    below the global valid count ``nr`` are valid. Returns ``(d2 [Nq],
    global indices [Nq] int32[, winning rows [Nq, 3]][, aux rows [Nq,
    C]])``; ``d2`` is ``+inf`` where the shard holds no valid row."""
    S = ref_local.shape[0]
    nr_local = min(max(int(nr) - int(offset), 0), S)
    d2, idx = knn(query, ref_local, nr_local, nq)
    out = [torch.full_like(d2, float("inf")) if nr_local == 0 else d2, idx + int(offset)]
    if with_points:
        out.append(ref_local.index_select(0, idx.long()))
    if aux_local is not None:
        out.append(aux_local.index_select(0, idx.long()))
    return tuple(out)


def combine(d2s: Tensor, *parts: Tensor):
    """The shards' results stacked on a leading ``[D]`` axis: ``d2s [D,
    Nq]`` and any number of ``[D, Nq, ...]`` parts. Each query takes the
    shard of least distance, the lowest on ties. Returns ``(d2 [Nq],
    *parts at the winner)``."""
    win = d2s.argmin(dim=0)

    def pick(x):
        w = win.reshape((1, -1) + (1,) * (x.ndim - 2)).expand((1,) + x.shape[1:])
        return x.gather(0, w)[0]

    return (pick(d2s),) + tuple(pick(x) for x in parts)


def all_gather_stack(t: Tensor, group=None) -> Tensor:
    """``t`` from every rank of ``group``, stacked ``[D, ...]`` in rank order."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


def knn_map_sharded(group, query: Tensor, ref_local: Tensor, nr=None, nq=None, *,
                    with_points: bool = False, aux: Optional[Tensor] = None):
    """Exact top-1 KNN of ``query [Nq, 3]`` (the same on every rank) in a map
    whose rank-``k`` shard ``ref_local [S, 3]`` holds the global rows
    ``[k*S, (k+1)*S)`` over ``group`` (None: the default group).

    ``nr``: the global valid count (default all ``D*S`` rows); ``nq``: the
    valid queries, forwarded to the shard searches (results past it are
    undefined). ``with_points`` adds the winning rows ``[Nq, 3]``; ``aux``
    (this rank's shard ``[S, C]`` of a companion buffer) its winning rows
    ``[Nq, C]``. Returns ``(d2 [Nq], global indices [Nq] int32[, points][,
    aux rows])``, the same on every rank."""
    D, k = dist.get_world_size(group), dist.get_rank(group)
    S = ref_local.shape[0]
    nr = D * S if nr is None else int(nr)
    local = shard_search(query, ref_local, k * S, nr, nq, with_points=with_points,
                         aux_local=aux)
    return combine(*(all_gather_stack(t, group) for t in local))
