"""Map compaction: merge duplicate surfels and pack the survivors.

The port of ``e2eslam_tpu/slam/compact.py``. Every valid row gets a key
(a bucket of a power-of-two table) and a coordinate; each occupied bucket
elects its lowest row as the winner; rows whose coordinate equals their
winner's (and, optionally, whose normal agrees with it) merge into the
winner, confidence-weighted; the survivors (winners, and rows that shared a
bucket but not the coordinate or the normal) are packed to the buffer's
prefix in row order. Two keys:

  * ``compact_map``: the voxel of each point (``MODEL.compact_live_voxel``
    in the adaptation loop, ``MODEL.compact_voxel`` at the end of a run);
  * ``compact_map_projective``: the pixel each point projects to in one
    camera plus a depth bin of the fusion gate, merged only where the
    normals agree: PointFusion's own merge rule (same pixel, ``dist_th``,
    ``angle_th``), run from the just-fused keyframe's camera.

A hash collision never merges: the coordinate check keeps collided rows
apart. The merged row is the confidence-weighted mean of positions,
normals (re-normalised) and colours, with the summed confidence; columns
10:16 are zeroed. The index images (``index_image``, ``index_image2``) are
remapped through each old row's new home (a merged row's is its winner's),
so a cached image stays valid; slot -1 stays -1.

Plain torch, as the JAX package's is XLA. The hashes multiply in int64 and
keep the table's low bits (the JAX package's int32 products wrap; their
low bits are the same), and float -> int conversions saturate as JAX's do.
The weighted sum is one ``index_add_`` (deterministic on the card under
``torch.use_deterministic_algorithms``). The new count is one host read
per pass.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from e2eslam_tpu_torch.core.se3 import se3_inverse, transform_points
from e2eslam_tpu_torch.ops.voxel_knn import _hash_coords, saturate_int32
from e2eslam_tpu_torch.slam.pointclouds import ROW, MapState

Tensor = torch.Tensor


def _per(x: Tensor, size: float) -> Tensor:
    """``x / size`` as the JAX package's compiled pass computes it: XLA turns
    a division by a constant into a product with its float32 reciprocal
    (which differs from the quotient in the last bit, enough to move a
    point across a voxel's or a depth bin's edge)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return x * (one / torch.tensor(size, dtype=x.dtype, device=x.device))


def _voxel_hash(points: Tensor, voxel: float, table_size: int):
    """(bucket keys [N] int64, integer voxel coordinates [N, 3] int64)."""
    v = saturate_int32(torch.floor(_per(points, voxel)))
    return _hash_coords(v[:, 0], v[:, 1], v[:, 2], table_size), v


def _compact_rows(m: MapState, key: Tensor, coord: Tensor, table_size: int,
                  normal_cos: Optional[float] = None) -> MapState:
    """Merge rows that share a bucket (``key`` in [0, table_size)) and a
    coordinate (``coord`` [N, C]); with ``normal_cos``, only where a row's
    normal agrees with its winner's (the winner always passes)."""
    N = m.data.shape[0]
    dev = m.data.device
    rows = torch.arange(N, dtype=torch.int64, device=dev)
    valid = rows < m.count
    # The lowest row of each occupied bucket wins; invalid rows take no part.
    table = torch.full((table_size,), N, dtype=torch.int64, device=dev)
    table.scatter_reduce_(0, key[valid], rows[valid], reduce="amin")
    winner = torch.where(valid, table[key.clamp(0, table_size - 1)], torch.full_like(rows, N))
    wsafe = winner.clamp(max=N - 1)
    same = valid & (coord == coord[wsafe]).all(dim=-1)
    is_winner = valid & (winner == rows)
    if normal_cos is not None:
        dot = (m.normals * m.normals[wsafe]).sum(dim=-1)
        same = same & ((dot >= normal_cos) | is_winner)
    # The confidence-weighted sum of every merging row, into its winner.
    w = torch.where(same, m.confidence, torch.zeros_like(m.confidence))
    fields = torch.cat([m.data[:, :9] * w[:, None], w[:, None]], dim=-1)
    acc10 = torch.zeros(N, 10, dtype=m.data.dtype, device=dev)
    acc10.index_add_(0, wsafe[same], fields[same])
    acc, wsum = acc10[:, :9], acc10[:, 9]
    merged = acc / wsum.clamp(min=1e-12)[:, None]
    nrm = merged[:, 3:6]
    n2 = (nrm * nrm).sum(dim=-1, keepdim=True)
    nrm = torch.where(n2 > 1e-24, nrm / torch.sqrt(torch.where(n2 > 1e-24, n2, 1.0)), nrm)
    merged = torch.cat([merged[:, 0:3], nrm, merged[:, 6:9], wsum[:, None],
                        m.data.new_zeros(N, ROW - 10)], dim=-1)
    # Survivors: winners (merged) and rows that kept apart (untouched),
    # packed to the prefix in row order.
    keep = is_winner | (valid & ~same)
    out_rows = torch.where(is_winner[:, None], merged, m.data)
    dest = torch.cumsum(keep.to(torch.int64), 0) - 1
    data = torch.zeros_like(m.data)
    data[dest[keep]] = out_rows[keep]
    count = int(keep.sum())
    # Each valid old row's new home: its own packed slot, or its winner's.
    home = torch.where(keep, dest, torch.full_like(dest, N))
    row_map = torch.where(same & ~is_winner, home[wsafe], home)
    row_map = torch.where(valid, row_map, torch.full_like(row_map, N))

    def remap(idx):
        if idx is None:
            return None
        new = row_map[idx.long().clamp(0, N - 1)]
        return torch.where((idx >= 0) & (new < N), new, torch.full_like(new, -1)).to(idx.dtype)

    return dataclasses.replace(m, data=data, count=count, index_image=remap(m.index_image),
                               index_image2=remap(m.index_image2))


def compact_map(m: MapState, *, voxel: float = 0.02, table_pow: int = 22) -> MapState:
    """Merge surfels that share a ``voxel``-metre voxel; the same capacity,
    a smaller ``count``, remapped index images."""
    T = 1 << table_pow
    key, vox = _voxel_hash(m.points, float(voxel), T)
    return _compact_rows(m, key, vox, T)


def compact_map_projective(m: MapState, pose: Tensor, K: Tensor, *, height: int, width: int,
                           dist_gate: float = 0.05, normal_gate_deg: Optional[float] = 20.0,
                           table_pow: int = 22) -> MapState:
    """Merge re-observation duplicates as the camera at ``pose``
    (camera-to-world) with intrinsics ``K`` sees them: same pixel, same
    ``dist_gate`` depth bin, normals within ``normal_gate_deg``. Points out
    of view keep a coordinate of their own and survive. Duplicates that
    straddle a depth-bin edge stay apart this pass."""
    N = m.data.shape[0]
    T = 1 << table_pow
    rows = torch.arange(N, dtype=torch.int64, device=m.data.device)
    cam = transform_points(se3_inverse(pose), m.points)
    z = cam[:, 2]
    zsafe = torch.where(z > 1e-6, z, torch.ones_like(z))
    u = saturate_int32(torch.round(K[0, 0] * cam[:, 0] / zsafe + K[0, 2]))
    v = saturate_int32(torch.round(K[1, 1] * cam[:, 1] / zsafe + K[1, 2]))
    in_view = (z > 1e-6) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    zbin = saturate_int32(torch.floor(_per(z, dist_gate)))
    coord = torch.stack([torch.where(in_view, u, -1 - rows),
                         torch.where(in_view, v, torch.full_like(v, -1)),
                         torch.where(in_view, zbin, torch.full_like(zbin, -1))], dim=-1)
    key = _hash_coords(coord[:, 0], coord[:, 1], coord[:, 2], T)
    cos = None if normal_gate_deg is None else math.cos(math.radians(float(normal_gate_deg)))
    return _compact_rows(m, key, coord, T, normal_cos=cos)
