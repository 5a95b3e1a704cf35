"""The global map: a fixed-capacity packed point buffer.

One ``[capacity, 16]`` float buffer holds each map point's fields in a row
(points 0:3, normals 3:6, colors 6:9, confidence 9; columns 10:16 pad the
row to 64 bytes), the JAX package's layout. ``count`` rows at the front
are valid; appends write at the ``count`` cursor. In the port the count is
a host integer, read after each fusion.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

Tensor = torch.Tensor

ROW = 16  # packed row width (floats)


@dataclass
class MapState:
    """Packed map rows plus the number of valid rows."""

    data: Tensor  # [N, 16]
    count: int

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


def pack_rows(points: Tensor, normals: Tensor, colors: Tensor,
              confidence: Tensor) -> Tensor:
    """Pack per-row fields [K, 3] x 3 + [K] into rows [K, ROW]."""
    pad = points.new_zeros(points.shape[0], ROW - 10)
    return torch.cat([points, normals, colors, confidence[:, None], pad], dim=-1)


def empty_map(capacity: int, device=None) -> MapState:
    return MapState(data=torch.zeros(capacity, ROW, device=device), count=0)
