"""Voxel-hash approximate nearest neighbour (``LOSS.knn_impl: voxel``).

The port of ``e2eslam_tpu/ops/voxel_knn.py``. Building the index (once per
map update) hashes each valid map point's integer voxel coordinates into a
power-of-two table, sorts the points by bucket and records each bucket's
first row. A query probes the 27 voxels around its own, the first
``max_per_voxel`` points of each bucket, and keeps the nearest by exact
distance. If the true nearest neighbour lies within one voxel and its
bucket is not truncated the answer is exact; queries with no candidate in
range come back with ``found`` False, and callers mask them out. Hash
collisions only add candidates.

Everything is plain torch (the JAX package's is XLA). The hash multiplies
in int64 and keeps the table's low bits: the JAX package multiplies in
int32 with wraparound, and the low bits of the two products are the same
bits (signed int32 overflow is undefined in C++, so torch's int32 product
is not used).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

_PRIMES = (73856093, 19349663, 83492791)
_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1


class VoxelIndex(NamedTuple):
    sorted_points: Tensor  # [N, 3] points ordered by bucket
    sorted_to_orig: Tensor  # [N] int32 original row of each sorted point
    bucket_start: Tensor  # [table_size + 1] int32 offsets into sorted_points
    voxel_size: Tensor  # [] float32


def _voxel_coords(points: Tensor, voxel_size: Tensor) -> Tensor:
    """``floor(points / voxel_size)`` as int64, saturated to int32's range
    as the JAX package's float -> int32 conversion saturates."""
    c = torch.floor(points / voxel_size).clamp(_INT32_MIN, 2.0**31)
    return c.to(torch.int64).clamp(max=_INT32_MAX)


def _hash_coords(ix: Tensor, iy: Tensor, iz: Tensor, table_size: int) -> Tensor:
    """The multiply-xor hash of int64 voxel coordinates, masked to the
    table (``e2eslam_tpu/ops/voxel_knn.py:50-52``)."""
    h = (ix * _PRIMES[0]) ^ (iy * _PRIMES[1]) ^ (iz * _PRIMES[2])
    return h & (table_size - 1)


def build_voxel_index(points: Tensor, count: int, voxel_size: float = 0.1, *,
                      table_size: int = 1 << 20) -> VoxelIndex:
    """The spatial hash over the first ``count`` rows of ``points``
    (``e2eslam_tpu/ops/voxel_knn.py:55-85``). Rows past ``count`` take the
    key ``table_size``, past every bucket; the sort is stable, as
    ``jnp.argsort`` is."""
    N = points.shape[0]
    dev = points.device
    vs = torch.full((), voxel_size, dtype=torch.float32, device=dev)
    coords = _voxel_coords(points, vs)
    h = _hash_coords(coords[:, 0], coords[:, 1], coords[:, 2], table_size)
    valid = torch.arange(N, device=dev) < count
    sort_key = torch.where(valid, h, torch.full_like(h, table_size))
    order = torch.argsort(sort_key, stable=True)
    bucket_start = torch.searchsorted(sort_key[order],
                                      torch.arange(table_size + 1, device=dev), right=False)
    return VoxelIndex(sorted_points=points.index_select(0, order),
                      sorted_to_orig=order.to(torch.int32),
                      bucket_start=bucket_start.to(torch.int32), voxel_size=vs)


def voxel_knn(query: Tensor, index: VoxelIndex, *, max_per_voxel: int = 16):
    """Approximate top-1 nearest neighbour of each query in the indexed
    cloud (``e2eslam_tpu/ops/voxel_knn.py:88-130``).

    Returns (sq_dists [Nq], orig_indices [Nq] int64, found [Nq] bool); where
    ``found`` is False the distance is 0 and the index arbitrary. Each of
    the 27 probes gathers ``[Nq, max_per_voxel, 3]`` candidates in turn."""
    H = index.bucket_start.shape[0] - 1
    n_sorted = index.sorted_points.shape[0]
    dev = query.device
    qc = _voxel_coords(query, index.voxel_size)
    best_d = torch.full((query.shape[0],), float("inf"), device=dev)
    best_i = torch.zeros(query.shape[0], dtype=torch.int64, device=dev)
    offs = torch.arange(max_per_voxel, device=dev)
    starts = index.bucket_start.long()
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                h = _hash_coords(qc[:, 0] + dx, qc[:, 1] + dy, qc[:, 2] + dz, H)
                start = starts.index_select(0, h)
                end = starts.index_select(0, h + 1)
                rows = start[:, None] + offs[None, :]  # [Nq, K]
                ok = rows < end[:, None]
                rows = rows.clamp(max=n_sorted - 1)
                cand = index.sorted_points[rows]  # [Nq, K, 3]
                d = cand - query[:, None, :]
                # ((x^2 + y^2) + z^2) in this order on every device
                d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
                d2 = torch.where(ok, d2, float("inf"))
                k_min, k_arg = d2.min(dim=1)  # the first minimum, as jnp.argmin
                sel = rows.gather(1, k_arg[:, None])[:, 0]
                better = k_min < best_d
                best_d = torch.where(better, k_min, best_d)
                best_i = torch.where(better, sel, best_i)
    found = torch.isfinite(best_d)
    orig = index.sorted_to_orig.index_select(0, best_i).long()
    return torch.where(found, best_d, torch.zeros_like(best_d)), orig, found
