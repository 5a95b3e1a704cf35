"""PointFusion: confidence-weighted surfel fusion into the fixed-capacity map.

gradslam's PointFusion step (the reference's ``models["SLAM"].step``,
``online_adaption.py:354-363``), as the JAX package's scatter fusion
(``pointfusion_step``):

  1. project every valid map point into the live camera; candidates land
     in-frustum on a pixel with valid live depth;
  2. a candidate is *similar* if its distance to that pixel's live vertex
     is below ``dist_th`` and its normal within ``angle_th`` of the live
     normal;
  3. per pixel the closest similar candidate wins (scatter-min on
     distance, then scatter-min on index: the lowest index wins a tie);
  4. winners take a confidence-weighted average with the live measurement,
     whose confidence is a Gaussian of the normalised pixel radius;
  5. live pixels no winner claimed are appended at the ``count`` cursor.

With an active window only the newest map rows take part in steps 1-4.
On a card, steps 1-4 of an in-place fusion are the CUDA kernels of
``ops/pointfusion.py`` (one 64-bit atomic-min per similar row on a key of
(distance bits, row): the closest row, then the lowest), which visit only
the candidate rows; ``_merge_plain`` is their plain version.
``projective_nn``, the projective 3D loss's association, runs steps 1-3
with no gates.

The index fusion (``pointfusion_step_index``, ``MODEL.fusion_impl:
index``) finds each live pixel's candidate by projecting it into the last
fused keyframe's camera and reading that keyframe's cached index image:
O(H*W) gathers and scatters, no pass over the map. ``index_nn`` is the 3D
loss's association through the same image.

The map's ``count`` (and two-level index fusion's ``kf_counter``) is a
python int or a 0-d int64 tensor on the map's device. A tensor stays a
tensor through fusion with no host read (the whole-sequence program replays
fusion in a CUDA graph); an int stays an int, read once per fusion. Rows
are written with ``index_copy_`` (``_write_rows``), never through a
boolean-mask index, and no shape depends on the count.

Fusion updates the map buffer in place, outside autograd, unless autograd
is on and the map or the frame requires grad (``PointFusion.__call__``
under the gradient-flow experiments, ``apps/gradient_experiments.py``):
then it builds new buffers out of place, so the gradient reaches the
frame's depth and colours through every fused and appended row, as it does
through the JAX package's functional scatters.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from e2eslam_tpu_torch.core.se3 import se3_inverse, transform_points
from e2eslam_tpu_torch.ops.pointfusion import fusion_kernel
from e2eslam_tpu_torch.slam.pointclouds import MapState, pack_rows
from e2eslam_tpu_torch.slam.rgbd import RGBDFrame

Tensor = torch.Tensor


class FramePoints(NamedTuple):
    """A frame's pixels as a flat (masked) point set [H*W, ...]."""

    points: Tensor  # [HW, 3] world frame
    normals: Tensor  # [HW, 3]
    colors: Tensor  # [HW, 3]
    mask: Tensor  # [HW] float validity


def frame_pointcloud(frame: RGBDFrame) -> FramePoints:
    """Flatten a frame into a masked point set."""
    HW = frame.depth.shape[0] * frame.depth.shape[1]
    return FramePoints(
        points=frame.vertices.reshape(HW, 3),
        normals=frame.normals.reshape(HW, 3),
        colors=frame.color.reshape(HW, 3),
        mask=frame.valid.reshape(HW),
    )


def _pixel_alpha(H: int, W: int, intrinsics: Tensor, sigma: float) -> Tensor:
    """Per-pixel measurement confidence: Gaussian in normalised pixel radius."""
    cx = intrinsics[0, 2]
    cy = intrinsics[1, 2]
    dev = intrinsics.device
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    gamma2 = ((xs - cx) ** 2 + (ys - cy) ** 2) / (cx**2 + cy**2 + 1e-12)
    return torch.exp(-gamma2 / (2.0 * sigma**2)).reshape(-1)


def _project_uv(points: Tensor, pose: Tensor, intrinsics: Tensor, H: int, W: int):
    """Project world points into a camera. Returns (ui, vi, in_frame)."""
    K = intrinsics
    p_cam = transform_points(se3_inverse(pose), points)
    z = p_cam[:, 2]
    safe_z = torch.where(z.abs() > 1e-8, z, torch.full_like(z, 1e-8))
    u = K[0, 0] * p_cam[:, 0] / safe_z + K[0, 2]
    v = K[1, 1] * p_cam[:, 1] / safe_z + K[1, 2]
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    in_frame = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & (z > 0)
    return ui, vi, in_frame


def _project_pixels(points: Tensor, pose: Tensor, intrinsics: Tensor, H: int, W: int):
    """Project world points into a camera. Returns (pix [N], in_frame [N])."""
    ui, vi, in_frame = _project_uv(points, pose, intrinsics, H, W)
    pix = vi.clamp(0, H - 1) * W + ui.clamp(0, W - 1)
    return pix, in_frame


def _cos_deg(angle_deg: float) -> float:
    # float32 math, as the JAX package evaluates the gate's threshold (the
    # result is a float32 value, so comparing float32 tensors with it is exact).
    return float(torch.cos(torch.deg2rad(torch.tensor(float(angle_deg)))))


def _associate(state: MapState, frame: RGBDFrame, live: FramePoints, *,
               dist_th: float, angle_th: Optional[float]):
    """Project map points into the frame and rank them per pixel
    (``e2eslam_tpu/slam/fusion.py:73-118``).

    Returns (pix [N], best_idx [HW], winner [N], v_live [N, 3], n_live):
    each map point's target pixel, each pixel's winning map row (``N``
    where none), the winner mask (one winner per pixel: the closest similar
    point, then the lowest index), and the live vertex and normal at each
    point's pixel. ``angle_th`` None skips the normal test (``n_live`` is
    then None).
    """
    H, W = frame.depth.shape[:2]
    HW = H * W
    N = state.data.shape[0]
    dev = state.data.device
    pix, in_frame = _project_pixels(state.points, frame.pose, frame.intrinsics, H, W)
    rows = torch.arange(N, device=dev)
    in_frame = in_frame & (rows < state.count)

    v_live = live.points[pix]
    dist = torch.linalg.norm(state.points - v_live, dim=-1)
    similar = in_frame & (live.mask[pix] > 0) & (dist < dist_th)
    n_live = None
    if angle_th is not None:
        n_live = live.normals[pix]
        similar = similar & ((state.normals * n_live).sum(dim=-1) > _cos_deg(angle_th))

    best_idx, winner = _rank(pix, dist, similar, HW)
    return pix, best_idx, winner, v_live, n_live


def _rank(pix: Tensor, dist: Tensor, similar: Tensor, HW: int):
    """Each pixel's winner among the similar rows that land on it: the
    closest, then the lowest row (a scatter-min on distance, then one on the
    rows at that distance). Returns (best_idx [HW], ``N`` where none;
    winner [N])."""
    N = pix.shape[0]
    dev = pix.device
    rows = torch.arange(N, device=dev)
    dist_m = torch.where(similar, dist, float("inf"))
    best_dist = torch.full((HW,), float("inf"), device=dev).scatter_reduce(
        0, pix, dist_m, "amin", include_self=True)
    is_best = similar & (dist_m <= best_dist[pix])
    idx_m = torch.where(is_best, rows, torch.full_like(rows, N))
    best_idx = torch.full((HW,), N, dtype=torch.int64, device=dev).scatter_reduce(
        0, pix, idx_m, "amin", include_self=True)
    return best_idx, is_best & (rows == best_idx[pix])


def count_add(count, added: Tensor, capacity: int):
    """``count + added`` capped at ``capacity``: a python int for an int
    ``count`` (one host read of ``added``), a 0-d tensor with no host read
    for a tensor one."""
    if isinstance(count, Tensor):
        return (count + added).clamp(max=capacity)
    return min(count + int(added), capacity)


def _write_rows(data: Tensor, tgt: Tensor, rows: Tensor, writes: Tensor) -> None:
    """``data[tgt[writes]] = rows[writes]`` in place with one ``index_copy_``
    and no boolean-mask index (which reads its nonzero count to the host):
    entries that write nothing repeat the last writer's write (or, with no
    writer at all, write row 0 back), a harmless duplicate of equal bytes."""
    ids = torch.arange(tgt.shape[0], device=tgt.device)
    last = torch.where(writes, ids, -1).amax().view(1)
    any_w = last >= 0
    last = last.clamp(min=0)
    sink_tgt = torch.where(any_w, tgt.index_select(0, last), 0)
    sink_row = torch.where(any_w[:, None], rows.index_select(0, last), data[:1])
    data.index_copy_(0, torch.where(writes, tgt, sink_tgt),
                     torch.where(writes[:, None], rows, sink_row))


def _window_start(count, N: int, window: int):
    """The first row of the newest ``window`` rows: ``clip(count - window, 0,
    max(N - window, 0))``, a python int for a host count, a 0-d tensor for a
    device one."""
    if isinstance(count, Tensor):
        return (count - window).clamp(min=0, max=max(N - window, 0))
    return min(max(count - window, 0), max(N - window, 0))


def _window_view(state: MapState, window: int):
    """The newest ``window`` rows of the map as a map of their own
    (``e2eslam_tpu/slam/fusion.py:121-138``): association and fusion then
    cost O(window) whatever the map's size. The start is ``_window_start``:
    for a host count the window is a slice of the buffer; for a device count
    a gather of the rows ``start + arange(window)`` (no host read; fusion
    writes them back). Returns (start, the rows gathered or None, sub-map)."""
    start = _window_start(state.count, state.data.shape[0], window)
    if isinstance(state.count, Tensor):
        rows = start + torch.arange(window, device=state.data.device)
        return start, rows, MapState(data=state.data.index_select(0, rows),
                                     count=(state.count - start).clamp(max=window))
    return start, None, MapState(data=state.data[start:start + window],
                                 count=min(state.count - start, window))


@torch.no_grad()
def projective_nn(state: MapState, frame: RGBDFrame, *, active_window: Optional[int] = None):
    """Each pixel's nearest map point among those that project onto it, with
    no distance or normal gate (``e2eslam_tpu/slam/fusion.py:140-163``):
    one projection of the map and a scatter-min, no KNN. ``active_window``
    limits the candidates to the newest W rows; the indices stay global.

    Returns (nn_idx [HW] int64 clipped to the candidates, found [HW] bool)."""
    start = 0
    if active_window is not None and active_window < state.data.shape[0]:
        start, _, state = _window_view(state, int(active_window))
    _, best_idx, _, _, _ = _associate(state, frame, frame_pointcloud(frame),
                                      dist_th=float("inf"), angle_th=None)
    N = state.data.shape[0]
    return start + best_idx.clamp(max=N - 1), best_idx < N


def _tracks_grad(state: MapState, frame: RGBDFrame) -> bool:
    """Whether a fusion step must carry autograd: autograd is on and the map
    or the frame's geometry or colours require grad."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (state.data, frame.vertices, frame.normals, frame.color))


def pointfusion_step(state: MapState, frame: RGBDFrame, *, dist_th: float = 0.05,
                     angle_th: Optional[float] = 20.0, sigma: float = 0.6,
                     active_window: Optional[int] = None,
                     active: Optional[Tensor] = None) -> MapState:
    """Fuse one live frame into the map: in place (the same buffer, with the
    new count), or out of place when it carries autograd (``_tracks_grad``).
    Returns the new state.

    The map-sized pass (association and the fusion of the winners) runs as
    the CUDA kernels of ``ops/pointfusion.py`` for an in-place call on a
    card, which visit only the candidate rows and read the count on the
    device; as ``_merge_plain`` on the CPU and for a call that carries
    autograd. The two fuse the same winners with the same arithmetic; the
    plain version also renormalises the other rows' normals (by at most two
    ulps for a unit normal), which the kernels leave as they are.

    ``active_window`` W (``e2eslam_tpu/slam/fusion.py:415-440``): only the
    newest W rows are association and fusion candidates; their fused rows
    are written back first, then the appends land in the full buffer.

    ``active`` (a 0-d bool tensor, or None: True): where False, the map
    comes out as it went in, bytes and count alike, with no host read (the
    multi-sequence program's masked commit, ``e2eslam_tpu/parallel/
    adaptation.py:150-154``)."""
    if _tracks_grad(state, frame):
        return _pointfusion_step(state, frame, dist_th, angle_th, sigma, active_window, active,
                                 inplace=False)
    with torch.no_grad():
        return _pointfusion_step(state, frame, dist_th, angle_th, sigma, active_window, active,
                                 inplace=True)


def _pointfusion_step(state, frame, dist_th, angle_th, sigma, active_window, active, *,
                      inplace):
    H, W = frame.depth.shape[:2]
    N = state.data.shape[0]
    live = frame_pointcloud(frame)
    alpha = _pixel_alpha(H, W, frame.intrinsics, sigma) * live.mask
    if inplace and state.data.is_cuda:
        data = state.data
        claimed = _merge_kernel(state, frame, live, alpha, dist_th, angle_th, active_window,
                                active)
    else:
        data, claimed = _merge_plain(state, frame, live, alpha, dist_th, angle_th,
                                     active_window, active, inplace=inplace)

    # ---- append the live pixels no winner claimed -----------------------
    new_mask = (live.mask > 0) & ~claimed
    if active is not None:
        new_mask = new_mask & active
    order = torch.cumsum(new_mask.to(torch.int64), 0) - 1
    dest = state.count + order
    ok = new_mask & (dest < N)
    live_rows = pack_rows(live.points, live.normals, live.colors, alpha)
    if inplace:
        _write_rows(data, dest, live_rows, ok)
    else:
        data = data.index_put((dest[ok],), live_rows[ok])
    return dataclasses.replace(state, data=data, count=count_add(state.count, new_mask.sum(), N))


def _merge_kernel(state, frame, live, alpha, dist_th, angle_th, active_window, active):
    """``_merge_plain``'s association and fusion of the winners through
    ``ops/pointfusion.py::fusion_kernel``, in place on a card. Returns
    ``claimed`` [HW] bool."""
    H, W = frame.depth.shape[:2]
    N = state.data.shape[0]
    window = N if active_window is None or active_window >= N else int(active_window)
    start = 0 if window == N else _window_start(state.count, N, window)
    K = frame.intrinsics
    params = torch.cat([se3_inverse(frame.pose)[:3].reshape(12), K[0, 0:1], K[1, 1:2],
                        K[0, 2:3], K[1, 2:3]]).float()
    return fusion_kernel(state.data, state.count, start, window, params,
                         *(t.contiguous() for t in (live.points, live.normals, live.colors,
                                                    live.mask, alpha)),
                         active, H, W, dist_th, None if angle_th is None else _cos_deg(angle_th))


def _merge_plain(state, frame, live, alpha, dist_th, angle_th, active_window, active, *,
                 inplace):
    """Association (``_associate``) and the confidence-weighted fusion of
    each pixel's winner, over the whole buffer in plain PyTorch (the CUDA
    kernels' plain version). Returns (the map's buffer, in place or new;
    ``claimed`` [HW] bool, the pixels a row won)."""
    HW = live.mask.shape[0]
    N = state.data.shape[0]
    windowed = active_window is not None and active_window < N
    start, rows, sub = _window_view(state, int(active_window)) if windowed else (0, None, state)

    pix, _, winner, v_live, n_live = _associate(
        sub, frame, live, dist_th=dist_th, angle_th=angle_th)
    if active is not None:
        winner = winner & active
    if n_live is None:  # no angle test: the normals are gathered here
        n_live = live.normals[pix]

    # ---- confidence-weighted fusion of the winners ----------------------
    a = alpha[pix]
    c = sub.confidence
    wsum = (c + a).clamp(min=1e-12)
    wf = winner[:, None].to(sub.data.dtype)

    def fuse(old, new):
        fused = (c[:, None] * old + a[:, None] * new) / wsum[:, None]
        return old + wf * (fused - old)

    points_w = fuse(sub.points, v_live)
    colors_w = fuse(sub.colors, live.colors[pix])
    normals_raw = fuse(sub.normals, n_live)
    n2 = (normals_raw * normals_raw).sum(dim=-1, keepdim=True)
    ok_n = n2 > 1e-24
    normals_w = torch.where(
        ok_n, normals_raw / torch.where(ok_n, n2, torch.ones_like(n2)).sqrt(),
        normals_raw)
    confidence_w = c + winner.to(c.dtype) * a
    sub_rows = pack_rows(points_w, normals_w, colors_w, confidence_w)
    if active is not None:
        # The renormalised normals move every row a little: keep the old.
        sub_rows = torch.where(active, sub_rows, sub.data)
    if inplace:
        if rows is None:
            sub.data.copy_(sub_rows)
        else:
            state.data.index_copy_(0, rows, sub_rows)
        data = state.data
    elif rows is not None:
        data = state.data.index_copy(0, rows, sub_rows)
    elif windowed:
        data = torch.cat([state.data[:start], sub_rows,
                          state.data[start + sub_rows.shape[0]:]])
    else:
        data = sub_rows
    claimed = torch.zeros(HW, dtype=torch.int64, device=pix.device).scatter_reduce(
        0, pix, winner.to(torch.int64), "amax", include_self=True)
    return data, claimed > 0


def _lookup(image: Tensor, pose: Tensor, live: FramePoints, frame: RGBDFrame):
    """Each live pixel's slot in an index image taken from ``pose``: the
    slot at the pixel its point projects to. Returns (slot [HW] int64, -1
    none; found [HW])."""
    H, W = frame.depth.shape[:2]
    q, in_view = _project_pixels(live.points.detach(), pose, frame.intrinsics, H, W)
    cand = image.index_select(0, q).long()
    return cand, in_view & (cand >= 0) & (live.mask > 0)


def index_nn(state: MapState, frame: RGBDFrame, *, levels: Optional[int] = None):
    """3D-loss association through the cached index image
    (``e2eslam_tpu/slam/fusion.py:188-231``): each live pixel's point is
    projected into the last fused keyframe's camera and takes that pixel's
    map slot. With two index levels, pixels the first misses fall back to
    the second, unless ``levels`` is 1.

    Returns (nn_idx [HW] int64 clipped to the buffer, found [HW] bool)."""
    if state.index_image is None:
        raise ValueError("index_nn needs a map with index images (MODEL.fusion_impl: index)")
    cand, found = _index_candidates(state, frame, frame_pointcloud(frame),
                                    second_level=levels is None or levels >= 2)
    return cand.clamp(0, state.data.shape[0] - 1), found


def _index_candidates(state: MapState, frame: RGBDFrame, live: FramePoints,
                      search_radius: int = 0, second_level: bool = True):
    """Index fusion's association (``e2eslam_tpu/slam/fusion.py:284-327``):
    each live pixel's candidate slot from the last keyframe's index image,
    the nearest of the (2r+1)^2 pixels around its projection with
    ``search_radius`` r > 0, then, where the map keeps a second level and
    ``second_level`` is set, that level's slot where the first has none.
    Returns (slot [HW] int64, -1 none; has_cand [HW])."""
    H, W = frame.depth.shape[:2]
    N = state.data.shape[0]
    valid = live.mask > 0
    if search_radius > 0:
        ui, vi, in_prev = _project_uv(live.points, state.index_pose, frame.intrinsics, H, W)
        best_d = torch.full((H * W,), float("inf"), device=state.data.device)
        cand = torch.full((H * W,), -1, dtype=torch.int64, device=state.data.device)
        r = int(search_radius)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                uo, vo = ui + dx, vi + dy
                ok = in_prev & (uo >= 0) & (uo < W) & (vo >= 0) & (vo < H)
                pix = vo.clamp(0, H - 1) * W + uo.clamp(0, W - 1)
                cand_o = state.index_image.index_select(0, pix).long()
                ok = ok & (cand_o >= 0) & valid
                p_o = state.data.index_select(0, cand_o.clamp(0, N - 1))[:, 0:3]
                d_o = torch.linalg.norm(live.points - p_o, dim=-1)
                better = ok & (d_o < best_d)
                best_d = torch.where(better, d_o, best_d)
                cand = torch.where(better, cand_o, cand)
        has_cand = cand >= 0
    else:
        cand, has_cand = _lookup(state.index_image, state.index_pose, live, frame)
    if state.index_image2 is not None and second_level:
        cand2, has2 = _lookup(state.index_image2, state.index_pose2, live, frame)
        cand = torch.where(has_cand, cand, cand2)
        has_cand = has_cand | has2
    return cand, has_cand


def pointfusion_step_index(state: MapState, frame: RGBDFrame, *, dist_th: float = 0.05,
                           angle_th: Optional[float] = 20.0, sigma: float = 0.6,
                           level2_period: int = 1, search_radius: int = 0,
                           active: Optional[Tensor] = None) -> MapState:
    """Index-image PointFusion (``e2eslam_tpu/slam/fusion.py:234-412``), in
    place on the map buffer, or out of place when it carries autograd
    (``_tracks_grad``: then each slot is written once, by its winner, so
    its gradient reaches that pixel alone). Returns the new state.

    Each live pixel's candidate slot comes from ``_index_candidates``. A
    similar candidate (distance below ``dist_th``, normal within
    ``angle_th``) takes the confidence-weighted blend of itself and the
    pixel; the other valid pixels are appended. The index image becomes
    this keyframe's slots.

    Several pixels may blend into one slot. The JAX package scatters their
    rows with last-writer-wins, which XLA on the CPU resolves as the
    highest pixel index winning the whole row; ``index_put_``'s order for
    duplicate indices is unspecified on CUDA. So the winner is chosen
    explicitly (a scatter-max of pixel ids per slot) and every write to a
    slot carries its winner's row: duplicates write equal bytes, and the
    result is the same on both devices and in every run.

    ``active`` (a 0-d bool tensor, or None): where False, nothing is written
    and the count, index images and keyframe counter stay as they were
    (``pointfusion_step``'s).
    """
    if _tracks_grad(state, frame):
        return _pointfusion_step_index(state, frame, dist_th, angle_th, sigma, level2_period,
                                       search_radius, active, inplace=False)
    with torch.no_grad():
        return _pointfusion_step_index(state, frame, dist_th, angle_th, sigma, level2_period,
                                       search_radius, active, inplace=True)


def _pointfusion_step_index(state, frame, dist_th, angle_th, sigma, level2_period,
                            search_radius, active, *, inplace):
    H, W = frame.depth.shape[:2]
    HW = H * W
    N = state.data.shape[0]
    if state.index_image is None:
        raise ValueError("pointfusion_step_index needs empty_map(..., index_hw=H*W)")
    dev = state.data.device
    live = frame_pointcloud(frame)
    alpha = _pixel_alpha(H, W, frame.intrinsics, sigma) * live.mask
    valid = live.mask > 0

    # ---- 1. associate through the index images, then gate ---------------
    cand, has_cand = _index_candidates(state, frame, live, search_radius)
    cand_c = cand.clamp(0, N - 1)
    cand_rows = state.data.index_select(0, cand_c)  # one packed gather
    m_pt, m_n, m_clr, c_cand = (cand_rows[:, 0:3], cand_rows[:, 3:6], cand_rows[:, 6:9],
                                cand_rows[:, 9])
    dist = torch.linalg.norm(live.points - m_pt, dim=-1)
    similar = has_cand & (dist < dist_th)
    if angle_th is not None:
        similar = similar & ((live.normals * m_n).sum(dim=-1) > _cos_deg(angle_th))
    if active is not None:
        similar = similar & active
        valid = valid & active

    # ---- 2. confidence-weighted blend, computed pixel-side ---------------
    wsum = (c_cand + alpha).clamp(min=1e-12)

    def blend(old, new):
        return (c_cand[:, None] * old + alpha[:, None] * new) / wsum[:, None]

    n_raw = blend(m_n, live.normals)
    n2 = (n_raw * n_raw).sum(dim=-1, keepdim=True)
    ok_n = n2 > 1e-24
    f_n = torch.where(ok_n, n_raw / torch.where(ok_n, n2, torch.ones_like(n2)).sqrt(), n_raw)
    fused_rows = pack_rows(blend(m_pt, live.points), f_n, blend(m_clr, live.colors), wsum)

    # ---- 3. the appends of the unmatched valid pixels ---------------------
    new_mask = valid & ~similar
    order = torch.cumsum(new_mask.to(torch.int64), 0) - 1
    dest = state.count + order
    ok = new_mask & (dest < N)
    live_rows = pack_rows(live.points, live.normals, live.colors, alpha)

    # ---- 4. one scatter of merges and appends; duplicates carry the winner
    # Merge targets are valid rows (below ``count``), appends lie past it.
    pix_ids = torch.arange(HW, device=dev)
    # One slot per valid row (a device count: per buffer row).
    n_slots = N if isinstance(state.count, Tensor) else max(state.count, 1)
    winner = torch.full((n_slots,), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, torch.where(similar, cand_c, 0),
                           torch.where(similar, pix_ids, -1), "amax")
    src = torch.where(similar, winner.index_select(0, torch.where(similar, cand_c, 0)), pix_ids)
    rows = torch.where(similar[:, None], fused_rows.index_select(0, src.clamp(min=0)), live_rows)
    writes = similar | ok
    tgt = torch.where(similar, cand_c, dest)
    if inplace:
        _write_rows(state.data, tgt, rows, writes)
        data = state.data
    else:
        once = writes & (~similar | (src == pix_ids))
        data = state.data.index_put((tgt[once],), rows[once])
    count = count_add(state.count, new_mask.sum(), N)

    # ---- 5. this keyframe's index image; the second level ----------------
    new_index = torch.where(similar, cand_c, torch.where(ok, dest, -1)).to(torch.int32)
    pose = frame.pose.to(state.index_pose.dtype)
    idx2, pose2, kctr = state.index_image2, state.index_pose2, state.kf_counter
    if state.index_image2 is not None:
        if level2_period <= 1 or kctr is None:
            # Level 2 is the previous keyframe's image (one-keyframe gaps).
            idx2, pose2 = state.index_image, state.index_pose
        elif isinstance(kctr, Tensor):
            # A slow level on a device counter: chosen on the device.
            due = kctr % level2_period == 0
            idx2, pose2 = torch.where(due, new_index, idx2), torch.where(due, pose, pose2)
        elif kctr % level2_period == 0:
            # A slow level: every K-th keyframe's image, held K keyframes.
            idx2, pose2 = new_index, pose
        kctr = None if kctr is None else kctr + (1 if active is None else active.long())
    if active is not None:
        new_index = torch.where(active, new_index, state.index_image)
        pose = torch.where(active, pose, state.index_pose)
        if idx2 is not None:
            idx2 = torch.where(active, idx2, state.index_image2)
            pose2 = torch.where(active, pose2, state.index_pose2)
    return dataclasses.replace(state, data=data, count=count, index_image=new_index,
                               index_pose=pose,
                               index_image2=idx2, index_pose2=pose2, kf_counter=kctr)
