"""Row gather and scatter over stacked per-sequence buffers.

The port of ``e2eslam_tpu/ops/batched_rows.py``. ``B`` sequences' buffers
stack on a leading axis, ``data [B, N, ...]``; a row index is a position
within its own sequence's ``N`` rows. The JAX package needs these ops as
``custom_vmap`` rules so that its vmapped fusion lowers to one row gather
or scatter; here they are plain tensor functions over the stacked buffer.

  * ``DEFAULT_ROW_OPS``: one sequence at a time (``data [B, N, ...]``,
    ``idx [B, ...]``), a gather and a scatter per sequence;
  * ``FLAT_ROW_OPS``: the batch flattened into the row axis, ``[B*N, ...]``,
    and one gather or scatter over it (index ``i`` of sequence ``b`` is
    row ``b*N + i``).

Both take the JAX index contracts (``batched_rows.py:13-21``):

  * ``take(data, idx)``: every index in ``[0, N-1]``; the flat take clips
    to it, a guard that keeps a broken contract inside its own sequence;
  * ``set(data, idx, rows)``: every index in ``[0, N]``, ``N`` meaning
    "drop this row". Any index outside ``[0, N-1]`` is dropped: the flat
    set maps it to ``B*N`` (``:105-108``), past the buffer, never into the
    next sequence. Equal indices write one of their rows, which one
    unspecified (as JAX's scatter).

The multi-sequence runner (``parallel/adaptation.py``) assembles every
sequence's window with the flat take (the JAX ``gather_pairs_flat``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

Tensor = torch.Tensor


class RowOps(NamedTuple):
    """The two row primitives over a stacked ``[B, N, ...]`` buffer."""

    take: Callable  # (data [B, N, ...], idx [B, ...]) -> rows [B, ..., ...]
    set: Callable  # (data [B, N, ...], idx [B, ...], rows [B, ..., ...]) -> data'


def _set_rows(flat: Tensor, idx: Tensor, rows: Tensor, limit: int) -> Tensor:
    """``flat`` with ``rows`` written at ``idx`` (flattened), indices
    outside ``[0, limit)`` dropped; a copy."""
    idx = idx.reshape(-1).long()
    rows = rows.reshape((idx.shape[0],) + flat.shape[1:])
    keep = (idx >= 0) & (idx < limit)
    out = flat.clone()
    out.index_put_((idx[keep],), rows[keep].to(out.dtype))
    return out


def _plain_take(data: Tensor, idx: Tensor) -> Tensor:
    N = data.shape[1]
    return torch.stack([d.index_select(0, i.reshape(-1).long().clamp(0, N - 1))
                        .reshape(i.shape + d.shape[1:]) for d, i in zip(data, idx)])


def _plain_set(data: Tensor, idx: Tensor, rows: Tensor) -> Tensor:
    N = data.shape[1]
    return torch.stack([_set_rows(d, i, r, N) for d, i, r in zip(data, idx, rows)])


DEFAULT_ROW_OPS = RowOps(take=_plain_take, set=_plain_set)


def _base(B: int, N: int, idx: Tensor) -> Tensor:
    """Each sequence's first flat row, shaped to broadcast against ``idx``."""
    return (torch.arange(B, device=idx.device, dtype=torch.int64) * N).reshape(
        (B,) + (1,) * (idx.ndim - 1))


def flat_take(data: Tensor, idx: Tensor) -> Tensor:
    """``data [B, N, ...]``, ``idx [B, ...]`` -> ``[B, ..., ...]``: one
    gather over the flat ``[B*N, ...]`` view."""
    B, N = data.shape[0], data.shape[1]
    flat = data.reshape((B * N,) + data.shape[2:])
    fidx = idx.long().clamp(0, N - 1) + _base(B, N, idx)
    return flat.index_select(0, fidx.reshape(-1)).reshape(idx.shape + data.shape[2:])


def flat_set(data: Tensor, idx: Tensor, rows: Tensor) -> Tensor:
    """``data`` with ``rows`` written at ``idx``, one scatter over the flat
    ``[B*N, ...]`` view; out-of-range indices map to ``B*N`` (dropped)."""
    B, N = data.shape[0], data.shape[1]
    flat = data.reshape((B * N,) + data.shape[2:])
    i = idx.long()
    fidx = torch.where((i >= 0) & (i < N), i + _base(B, N, idx), torch.full_like(i, B * N))
    return _set_rows(flat, fidx, rows, B * N).reshape(data.shape)


FLAT_ROW_OPS = RowOps(take=flat_take, set=flat_set)
