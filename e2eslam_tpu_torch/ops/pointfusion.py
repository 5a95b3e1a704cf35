"""Scatter PointFusion's map-sized pass as CUDA kernels (``ops/csrc/pointfusion.cu``).

``fusion_kernel`` associates the map's valid rows with a live frame and
fuses each pixel's winner with the pixel, in place, reading the count (and
an active window's start) on the device: the pass costs what the valid rows
cost, not the buffer's capacity, and a launch captured in a CUDA graph
follows a count that changes between replays. Its plain version is
``slam/fusion.py::_merge_plain``, which the CPU and the autograd path take;
``slam/fusion.py::_pointfusion_step`` chooses. On a tensor it cannot take
the wrapper raises; it never falls back. It counts its launches in a plain
integer attribute, ``launches``, as ``ops/knn.py``'s wrappers do.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from e2eslam_tpu_torch.ops.knn import _Wrapper
from e2eslam_tpu_torch.slam.pointclouds import ROW

Tensor = torch.Tensor

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _L, _L, _L, _L] + [_P] * 9 + [_I, _I, _F, _F, _I, _P]


def _fn():
    from e2eslam_tpu_torch.ops.cuda_build import load

    fn = load("pointfusion").pointfusion_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _need(name: str, t: Tensor, dtype, shape, dev) -> None:
    if t.device != dev or t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name}: need a contiguous {dtype} tensor {shape} on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


@_Wrapper
def fusion_kernel(self, data: Tensor, count: Union[int, Tensor], start: Union[int, Tensor],
                  window: int, params: Tensor, live_points: Tensor, live_normals: Tensor,
                  live_colors: Tensor, live_mask: Tensor, alpha: Tensor,
                  active: Optional[Tensor], H: int, W: int, dist_th: float,
                  cos_th: Optional[float]) -> Tensor:
    """Fuse a live frame's winners into ``data`` (float32 ``[N, ROW]`` on a
    CUDA card) in place; returns ``claimed`` (bool ``[H*W]``): the pixels a
    map row won.

    The candidates are the rows ``[start, min(count, start + window))``;
    ``count`` and ``start`` are python ints or 0-d int64 tensors on the
    card (read there). ``params`` float32 ``[16]``: rows 0-2 of the live
    frame's inverse pose, then fx, fy, cx, cy. The live arrays are the
    frame's ``[H*W, 3]`` vertices, normals and colours, its ``[H*W]`` mask
    and confidence ``alpha``; ``active`` a 0-d bool tensor (False: nothing
    fused, nothing claimed) or None. ``cos_th`` None skips the normal gate."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"fusion_kernel runs on a CUDA card; data is on {dev}")
    N, HW = data.shape[0], H * W
    _need("data", data, torch.float32, (N, ROW), dev)
    if N >= 2 ** 32 or data.data_ptr() % 16:
        raise ValueError("data: a key holds the row in 32 bits, and rows are read 16 bytes "
                         "at a time")
    if not 0 < window <= N:
        raise ValueError(f"window {window} must lie in (0, {N}]")
    _need("params", params, torch.float32, (16,), dev)
    for name, t, shape in (("live_points", live_points, (HW, 3)),
                           ("live_normals", live_normals, (HW, 3)),
                           ("live_colors", live_colors, (HW, 3)),
                           ("live_mask", live_mask, (HW,)), ("alpha", alpha, (HW,))):
        _need(name, t, torch.float32, shape, dev)
    for name, t in (("count", count), ("start", start)):
        if isinstance(t, Tensor):
            _need(name, t, torch.int64, (), dev)
    if active is not None:
        _need("active", active, torch.bool, (), dev)
    lo = 0 if isinstance(start, Tensor) else int(start)
    hi = N if isinstance(count, Tensor) else int(count)
    # The host's bound on the rows the association visits, which sizes its grid.
    span = window if isinstance(count, Tensor) or isinstance(start, Tensor) else max(
        0, min(hi, lo + window) - lo)
    key = torch.empty(HW, dtype=torch.int64, device=dev)
    claimed = torch.empty(HW, dtype=torch.bool, device=dev)

    def ptr(t):
        return t.data_ptr() if isinstance(t, Tensor) else None

    err = _fn()(data.data_ptr(), ptr(count), ptr(start), lo, hi, window, span,
                params.data_ptr(), live_points.data_ptr(), live_normals.data_ptr(),
                live_colors.data_ptr(), live_mask.data_ptr(), alpha.data_ptr(), ptr(active),
                key.data_ptr(), claimed.data_ptr(), H, W, float(dist_th),
                0.0 if cos_th is None else float(cos_th), int(cos_th is not None),
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pointfusion_launch failed to launch: CUDA error {err}")
    self.launches += 1
    return claimed
