"""SE(3) rigid-transform utilities (batched torch, differentiable).

The port of ``e2eslam_tpu/core/se3.py``: the closed-form inverse, the
exponential and logarithm maps the ICP solver steps with, and the
frame-to-frame relative transforms. Every branch point of the maps keeps
the JAX package's double ``where``: ``torch.where``, like ``jnp.where``,
multiplies the discarded branch's gradient by zero, and ``0 * inf`` is NaN,
so each discarded branch is evaluated on a safe input.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def se3_inverse(T: Tensor) -> Tensor:
    """Closed-form inverse of rigid transform(s) ``[..., 4, 4]``.

    ``inv([R | t]) = [R^T | -R^T t]`` (the reference's ``torch.pinverse``
    is exact only up to its SVD; the closed form is exact for SE(3)).
    """
    R = T[..., :3, :3]
    t = T[..., :3, 3:4]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ t)], dim=-1)
    bottom = torch.zeros_like(T[..., :1, :])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def _skew(w: Tensor) -> Tensor:
    """Skew-symmetric matrices ``[..., 3, 3]`` of vectors ``[..., 3]``
    (``e2eslam_tpu/core/se3.py:41-52``)."""
    zeros = torch.zeros_like(w[..., 0])
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    return torch.stack([
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ], dim=-2)


def _bottom_row(like: Tensor, batch) -> Tensor:
    """``[..., 1, 4]`` rows (0, 0, 0, 1), made on the device: a host value
    written into a CUDA tensor is a copy that waits for the card, and the
    exponential map runs inside the ICP loop."""
    return torch.eye(4, dtype=like.dtype, device=like.device)[3:].expand(*batch, 1, 4)


def se3_exp(xi: Tensor) -> Tensor:
    """Exponential map of twists ``[..., 6]`` (v, w) to ``[..., 4, 4]``
    (``e2eslam_tpu/core/se3.py:55-85``). Below theta = 1e-4 the
    coefficients take their small-angle series, so the map is differentiable
    at the identity."""
    v = xi[..., :3]
    w = xi[..., 3:]
    theta2 = (w * w).sum(dim=-1, keepdim=True)[..., None]  # [..., 1, 1]
    theta = torch.sqrt(theta2 + 1e-30)
    W = _skew(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    # sin(t)/t, (1 - cos t)/t^2, (t - sin t)/t^3 with their series.
    small = theta < 1e-4
    safe_t = torch.where(small, torch.ones_like(theta), theta)
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe_t) / safe_t)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe_t)) / safe_t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (safe_t - torch.sin(safe_t)) / (safe_t2 * safe_t))
    R = eye + A * W + B * W2
    V = eye + B * W + C * W2
    t = V @ v[..., None]
    return torch.cat([torch.cat([R, t], dim=-1), _bottom_row(xi, xi.shape[:-1])], dim=-2)


def se3_log(T: Tensor) -> Tensor:
    """Logarithm map ``[..., 4, 4] -> [..., 6]`` (v, w)
    (``e2eslam_tpu/core/se3.py:88-183``).

    Small-angle series below theta = 1e-4; within 0.05 of pi the axis comes
    from the symmetric part ``(R + R^T)/2 - cos(theta) I = (1 - cos theta)
    a a^T`` (its largest column), its sign from the antisymmetric part."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    trace = R.diagonal(dim1=-2, dim2=-1).sum(dim=-1)
    cos_theta = ((trace - 1.0) / 2.0).clamp(-1.0, 1.0)
    # arccos' derivative is infinite at +-1: evaluate it on a safe interior
    # value and select the boundary answer outside it (:106-114).
    sat_hi = cos_theta >= 1.0 - 1e-12
    sat_lo = cos_theta <= -1.0 + 1e-12
    safe_cos = torch.where(sat_hi | sat_lo, torch.zeros_like(cos_theta), cos_theta)
    theta = torch.where(sat_hi, torch.zeros_like(cos_theta),
                        torch.where(sat_lo, torch.full_like(cos_theta, math.pi),
                                    torch.arccos(safe_cos)))[..., None, None]
    theta2 = theta * theta
    small = theta < 1e-4
    near_pi = theta > (math.pi - 0.05)
    ones = torch.ones_like(theta)
    safe_sin = torch.where(small | near_pi, ones, torch.sin(theta))
    coef = torch.where(small, 0.5 + theta2 / 12.0, theta / (2.0 * safe_sin))
    W = coef * (R - R.transpose(-1, -2))
    w_gen = torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)

    # The near-pi branch on a substituted pi-rotation diag(1, -1, -1) away
    # from pi, so the discarded branch stays finite both ways (:120-136).
    npb = near_pi[..., 0, 0]
    e0 = torch.eye(3, dtype=T.dtype, device=T.device)[:1]
    pi_rot = 2.0 * e0.T * e0 - torch.eye(3, dtype=T.dtype, device=T.device)  # diag(1, -1, -1)
    R_safe = torch.where(npb[..., None, None], R, pi_rot.expand(R.shape))
    cos_safe = torch.where(npb, cos_theta, torch.full_like(cos_theta, -1.0))
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(R.shape)
    Bp = 0.5 * (R_safe + R_safe.transpose(-1, -2)) - cos_safe[..., None, None] * eye
    col = torch.linalg.vector_norm(Bp, dim=-2).argmax(dim=-1)
    axis = torch.take_along_dim(Bp, col[..., None, None].expand(*Bp.shape[:-1], 1),
                                dim=-1)[..., 0]
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True).clamp(min=1e-12)
    asym = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sign = torch.where((axis * asym).sum(dim=-1, keepdim=True) < 0.0,
                       -torch.ones_like(axis[..., :1]), torch.ones_like(axis[..., :1]))
    w_pi = theta[..., 0] * sign * axis
    w = torch.where(near_pi[..., 0], w_pi, w_gen)
    W = _skew(w)

    # V^-1 = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    A = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, ones, theta))
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, ones, theta2))
    coef2 = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                        (1.0 - A / (2.0 * B)) / torch.where(small, ones, theta2))
    Vinv = eye - 0.5 * W + coef2 * (W @ W)
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def poses_to_transforms(poses: Tensor) -> Tensor:
    """Absolute poses ``[B, L, 4, 4]`` (or ``[L, 4, 4]``) to frame-to-frame
    transforms: slot 0 the identity, slot k ``inv(P_{k-1}) @ P_k``
    (``e2eslam_tpu/core/se3.py:186-208``)."""
    squeeze = poses.ndim == 3
    if squeeze:
        poses = poses[None]
    rel = se3_inverse(poses[:, :-1]) @ poses[:, 1:]
    eye = torch.eye(4, dtype=poses.dtype, device=poses.device).expand(poses[:, :1].shape)
    out = torch.cat([eye, rel], dim=1)
    return out[0] if squeeze else out


def camera_center(pose: Tensor) -> Tensor:
    """Reference-parity keyframe "center" ``-R^T t`` (not the true c2w center)."""
    R = pose[..., :3, :3]
    t = pose[..., :3, 3]
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


def frame_distance(prev_pose: Tensor, cur_pose: Tensor) -> Tensor:
    """Euclidean distance between two poses' ``camera_center``s."""
    return torch.linalg.norm(camera_center(prev_pose) - camera_center(cur_pose), dim=-1)


def transform_points(T: Tensor, points: Tensor) -> Tensor:
    """Apply rigid transform(s) ``[..., 4, 4]`` to points ``[..., N, 3]``."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return points @ R.transpose(-1, -2) + t[..., None, :]
