"""The global map: a fixed-capacity packed point buffer.

One ``[capacity, 16]`` float buffer holds each map point's fields in a row
(points 0:3, normals 3:6, colors 6:9, confidence 9; columns 10:16 pad the
row to 64 bytes), the JAX package's layout. ``count`` rows at the front
are valid; appends write at the ``count`` cursor. The count is a python int
(the per-keyframe loop reads it to the host after each fusion) or a 0-d
int64 tensor on the map's device (``on_device``: the whole-sequence program
never reads it, so its events can replay as a CUDA graph).

Index fusion (``MODEL.fusion_impl: index``) also keeps the last fused
keyframe's per-pixel map slots (``index_image``, int32, -1 where no map
point) with that keyframe's pose, and with ``MODEL.index_levels: 2`` a
second, older level and a fused-keyframe counter (an int or a tensor, as
``count`` is). They are ``None`` unless the config needs them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

Tensor = torch.Tensor

ROW = 16  # packed row width (floats)


@dataclass
class MapState:
    """Packed map rows plus the number of valid rows."""

    data: Tensor  # [N, 16]
    count: Union[int, Tensor]  # a python int, or a 0-d int64 tensor on data's device
    index_image: Optional[Tensor] = None  # [H*W] int32 map slot per pixel, -1 none
    index_pose: Optional[Tensor] = None  # [4, 4] pose of the index image's frame
    index_image2: Optional[Tensor] = None  # the second level's slots
    index_pose2: Optional[Tensor] = None
    kf_counter: Optional[Union[int, Tensor]] = None  # fused keyframes; iff two levels

    @property
    def points(self) -> Tensor:  # [N, 3] world-frame positions
        return self.data[:, 0:3]

    @property
    def normals(self) -> Tensor:  # [N, 3]
        return self.data[:, 3:6]

    @property
    def colors(self) -> Tensor:  # [N, 3]
        return self.data[:, 6:9]

    @property
    def confidence(self) -> Tensor:  # [N]
        return self.data[:, 9]


def on_device(m: MapState) -> MapState:
    """``m`` with its count and keyframe counter as 0-d int64 tensors on its
    buffer's device (the same buffers otherwise)."""
    def dev(n):
        if n is None or isinstance(n, Tensor):
            return n
        return torch.full((), int(n), dtype=torch.int64, device=m.data.device)

    return dataclasses.replace(m, count=dev(m.count), kf_counter=dev(m.kf_counter))


def pack_rows(points: Tensor, normals: Tensor, colors: Tensor,
              confidence: Tensor) -> Tensor:
    """Pack per-row fields [K, 3] x 3 + [K] into rows [K, ROW]."""
    pad = points.new_zeros(points.shape[0], ROW - 10)
    return torch.cat([points, normals, colors, confidence[:, None], pad], dim=-1)


def empty_map(capacity: int, device=None, index_hw: Optional[int] = None,
              index_levels: int = 1) -> MapState:
    """An empty map; with ``index_hw`` the index images (filled with -1)
    and identity poses of ``index_levels`` levels (1 or 2)."""
    def image():
        return torch.full((index_hw,), -1, dtype=torch.int32, device=device)

    def pose():
        return torch.eye(4, device=device)

    index = index_hw is not None
    two = index and index_levels >= 2
    return MapState(data=torch.zeros(capacity, ROW, device=device), count=0,
                    index_image=image() if index else None,
                    index_pose=pose() if index else None,
                    index_image2=image() if two else None,
                    index_pose2=pose() if two else None,
                    kf_counter=0 if two else None)


def map_from_arrays(fields, device=None) -> MapState:
    """A map from host arrays named as ``MapState``'s fields (a mapping, for
    example a JAX package map's ``_asdict()`` moved to numpy): the packed
    rows, the count, and the index images, poses and counter where present."""
    def tensor(name):
        value = fields.get(name)
        return None if value is None else torch.as_tensor(np.array(value), device=device)

    counter = fields.get("kf_counter")
    return MapState(data=tensor("data"), count=int(fields["count"]),
                    index_image=tensor("index_image"), index_pose=tensor("index_pose"),
                    index_image2=tensor("index_image2"), index_pose2=tensor("index_pose2"),
                    kf_counter=None if counter is None else int(counter))


def map_points(state: MapState):
    """(points [N, 3], valid mask [N]) of the buffer: the first ``count``
    rows are valid (a device count stays on the device)."""
    rows = torch.arange(state.data.shape[0], device=state.data.device)
    return state.points, rows < state.count
