"""Projective point-to-plane ICP odometry: gradICP and Gauss-Newton ICP.

The port of ``e2eslam_tpu/slam/odometry.py`` (gradslam's ``odom='icp' |
'gradicp'``; the reference selects it at ``online_adaption.py:117``, 20
iterations per ``configs/config.yaml:34``). Each iteration associates the
live points with the previous frame's vertex map by projection, builds the
6x6 point-to-plane normal equations and solves them by Cholesky.
gradICP blends each candidate step in by a sigmoid of the error decrease
and adapts its damping the same way, so gradients flow through the
accept/reject decision (the gradLM trick).

The loop is a fixed number of Python iterations with no host read inside
it: every gate is a ``torch.where`` on device tensors. The normal
equations run in full float32 (the JAX package's ``Precision.HIGHEST``):
``set_full_fp32`` keeps TF32 out of the matmuls.
"""

from __future__ import annotations

import torch

from e2eslam_tpu_torch.core.camera import inverse_intrinsics
from e2eslam_tpu_torch.core.projection import backproject
from e2eslam_tpu_torch.core.se3 import se3_exp, transform_points
from e2eslam_tpu_torch.device import set_full_fp32
from e2eslam_tpu_torch.slam.rgbd import RGBDFrame, normal_map

Tensor = torch.Tensor

# Projected pixel coordinates are clamped to this range before rounding:
# JAX's float -> int32 conversion saturates, torch's float -> int64 of a
# huge value is undefined on the CPU. Any clamped value is out of frame.
_PIX_LIMIT = 1e7


def _associate(src_pts: Tensor, src_mask: Tensor, T: Tensor, tgt_vertices: Tensor,
               tgt_normals: Tensor, tgt_mask: Tensor, K: Tensor, dist_th: float):
    """Projective data association (``e2eslam_tpu/slam/odometry.py:30-63``):
    the live points ``[M, 3]`` moved by ``T`` into the previous camera, the
    previous frame's normal at the pixel each lands on, the point-to-plane
    residual and the weight (in frame, valid on both sides, closer than
    ``dist_th``). Returns (p, n, r, w)."""
    H, W = tgt_vertices.shape[:2]
    p = transform_points(T, src_pts)
    z = p[:, 2].clamp(min=1e-8)
    u = (K[0, 0] * p[:, 0] / z + K[0, 2]).clamp(-_PIX_LIMIT, _PIX_LIMIT)
    v = (K[1, 1] * p[:, 1] / z + K[1, 2]).clamp(-_PIX_LIMIT, _PIX_LIMIT)
    u = torch.round(u).to(torch.int64)  # half to even, as jnp.round
    v = torch.round(v).to(torch.int64)
    inb = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (p[:, 2] > 0)
    pix = v.clamp(0, H - 1) * W + u.clamp(0, W - 1)
    q = tgt_vertices.reshape(-1, 3).index_select(0, pix)
    n = tgt_normals.reshape(-1, 3).index_select(0, pix)
    m = tgt_mask.reshape(-1).index_select(0, pix)
    diff = p - q
    # The JAX package's product of 0/1 gates with the masks, as one select.
    w = torch.where(inb & (torch.linalg.vector_norm(diff, dim=-1) < dist_th), m * src_mask, 0.0)
    r = (n * diff).sum(dim=-1)
    return p, n, r, w


def _normal_equations(p: Tensor, n: Tensor, r: Tensor, w: Tensor):
    """``J^T W J`` (6x6), ``J^T W r`` (6) and the weighted mean squared
    residual, for the twist (v, w) (``odometry.py:66-73``)."""
    J = torch.cat([n, torch.linalg.cross(p, n, dim=-1)], dim=-1)  # [M, 6]
    Jw = J * w[:, None]
    JTJ = Jw.T @ J
    JTr = (Jw.T @ r[:, None])[:, 0]
    err = (w * r * r).sum() / w.sum().clamp(min=1.0)
    return JTJ, JTr, err


def point_to_plane_icp(live_pts: Tensor, live_mask: Tensor, prev_frame_vertices: Tensor,
                       prev_frame_normals: Tensor, prev_frame_mask: Tensor,
                       intrinsics: Tensor, *, numiters: int = 20, dist_th: float = 0.2,
                       damping: float = 1e-6, lambda_max: float = 2.0, B: float = 1.0,
                       B2: float = 1.0, nu: float = 200.0, soft: bool = True,
                       init_T: Tensor | None = None) -> Tensor:
    """The live->prev rigid transform ``T`` (``T @ p_live ~ p_prev``,
    camera frames; ``e2eslam_tpu/slam/odometry.py:76-152``).

    ``soft=True`` is gradICP (smooth Levenberg-Marquardt gating),
    ``soft=False`` Gauss-Newton with constant damping (gradslam's ``icp``).
    An iteration with at most 32 weighted correspondences, a failed
    Cholesky factorisation or a non-finite step holds the pose."""
    set_full_fp32()
    dev, dt = live_pts.device, live_pts.dtype
    T = torch.eye(4, dtype=dt, device=dev) if init_T is None else init_T
    lam = torch.full((), damping, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def assoc(T):
        return _associate(live_pts, live_mask, T, prev_frame_vertices, prev_frame_normals,
                          prev_frame_mask, intrinsics, dist_th)

    def error_of(T):
        _, _, r, w = assoc(T)
        return (w * r * r).sum() / w.sum().clamp(min=1.0)

    for _ in range(numiters):
        p, n, r, w = assoc(T)
        JTJ, JTr, err = _normal_equations(p, n, r, w)
        # A Tikhonov floor scaled by the problem, plus the LM lambda.
        tikhonov = damping + lam + 1e-6 * JTJ.diagonal().sum() / 6.0
        A = JTJ + tikhonov * eye6
        # jax.scipy.linalg.solve(assume_a="pos") factors by Cholesky and
        # gives NaN where that fails; cholesky_ex reports the failure in
        # ``info`` (no host check) and leaves a finite partial factor, so
        # the gate reads ``info`` too, and a failed factor is replaced
        # before the solve so its backward stays finite.
        L, info = torch.linalg.cholesky_ex(A)
        factored = info == 0
        L = torch.where(factored, L, eye6)
        xi = -torch.cholesky_solve(JTr[:, None], L)[:, 0]
        enough = (w.sum() > 32.0) & factored & torch.isfinite(xi).all()
        xi = torch.where(enough, xi, torch.zeros_like(xi))
        if not soft:
            T = se3_exp(xi) @ T
            continue
        err_new = error_of(se3_exp(xi) @ T)
        gate = torch.sigmoid(B * (err - err_new))
        T = se3_exp(gate * xi) @ T
        lam = (lam * (torch.sigmoid(B2 * (err_new - err)) * (nu - 1.0 / nu) + 1.0 / nu)
               ).clamp(1e-8, lambda_max)
    return T


def gradicp(live_frame: RGBDFrame, prev_frame: RGBDFrame, *, numiters: int = 20,
            dist_th: float = 0.2, downsample: int = 1, soft: bool = True) -> Tensor:
    """Frame-to-frame odometry; returns the live frame's world pose
    (``e2eslam_tpu/slam/odometry.py:155-186``).

    The live frame's points (every ``downsample``-th pixel) in the live
    camera meet the previous frame's vertex and normal maps in its own
    camera (normals with zero borders); the solved live->prev transform is
    composed with the previous frame's world pose."""
    K = live_frame.intrinsics
    inv_K = inverse_intrinsics(K)[None]
    live_cam = backproject(live_frame.depth[None], inv_K)[0]
    prev_cam = backproject(prev_frame.depth[None], inv_K)[0]
    s = downsample
    T_live_to_prev = point_to_plane_icp(
        live_cam[::s, ::s].reshape(-1, 3), live_frame.valid[::s, ::s].reshape(-1),
        prev_cam, normal_map(prev_cam, edge="zero"), prev_frame.valid[..., 0], K,
        numiters=numiters, dist_th=dist_th, soft=soft)
    return prev_frame.pose @ T_live_to_prev
