"""Morton-order (Z-curve) spatial sort of the map's points.

The exact KNN prunes (query tile, ref tile) pairs by bounding box, so its
cost is set by how many ref tiles overlap a query tile. An append-ordered
map interleaves every keyframe's cloud along the trajectory; sorted by
Morton code, spatially close points are contiguous and the overlap set
collapses. The sort permutes the reference set and nothing else, so the
search stays exact. Invalid rows (past ``count``) take the largest key and
sort to the end, which keeps the valid-prefix convention of ``nr``/``nq``.

Torch has no ``<<`` for ``uint32``, so the codes are computed in int64 with
the JAX package's 30-bit layout; the invalid key ``0xFFFFFFFF`` stays above
every valid code.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

INVALID_KEY = 0xFFFFFFFF


class SortedMap(NamedTuple):
    """A spatially sorted view of a map's points.

    points:   [N, 3] Morton-sorted positions (invalid rows at the end).
    perm:     [N] int64 — ``points[i] == original[perm[i]]``.
    inv_perm: [N] int64 — ``inv_perm[perm[i]] == i`` (original row ->
              sorted position).
    """

    points: Tensor
    perm: Tensor
    inv_perm: Tensor


def _spread_bits(v: Tensor) -> Tensor:
    """Spread the low 10 bits of ``v`` to every third bit."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(points: Tensor, valid: Tensor) -> Tensor:
    """30-bit Morton codes (int64) over the valid points' bounding box;
    invalid rows get ``INVALID_KEY``."""
    lo = torch.where(valid[:, None], points, 1e30).amin(dim=0)
    hi = torch.where(valid[:, None], points, -1e30).amax(dim=0)
    extent = (hi - lo).clamp(min=1e-6)
    q = ((points - lo) / extent * 1024.0).clamp(0.0, 1023.0).to(torch.int64)
    code = (_spread_bits(q[:, 0]) | (_spread_bits(q[:, 1]) << 1)
            | (_spread_bits(q[:, 2]) << 2))
    return torch.where(valid, code, torch.full_like(code, INVALID_KEY))


def sort_map_points(points: Tensor, count) -> SortedMap:
    """Morton-sort ``points`` whose first ``count`` rows are valid (a python
    int, or a 0-d tensor on their device, never read by the host). Stable,
    so equal codes (and the invalid tail) keep their order."""
    n = points.shape[0]
    valid = torch.arange(n, device=points.device) < count
    perm = torch.argsort(morton_codes(points, valid), stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=points.device)
    return SortedMap(points=points[perm], perm=perm, inv_perm=inv)


def regather_sorted(points: Tensor, perm: Tensor, inv_perm: Tensor) -> SortedMap:
    """Refresh a sorted view through a stale permutation: one gather, no
    argsort (``LOSS.knn_sort_period`` > 1, between re-sorts).

    The sort is stable and keys invalid rows to the largest code, so the
    permutation's tail is the identity over the rows invalid at sort time:
    rows appended since then land in the view's tail at their own
    positions, in append order, and the valid rows still form the view's
    prefix ``[0, count)`` as long as the count has not decreased. ``perm``
    and ``inv_perm`` are unchanged, so index translation stays exact; only
    the pruning loses (the new rows are not Morton-placed).
    """
    return SortedMap(points=points[perm], perm=perm, inv_perm=inv_perm)
