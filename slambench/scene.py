"""The benchmark's synthetic RGB-D scene: a frozen torch copy of the port's
renderer (``e2eslam_tpu_torch/data/synthetic.py``: ``_pose``,
``_pose_revisit``, ``_render``, ``_texture`` without the textureless and
jitter options, and ``SyntheticDataset``'s windowing and intrinsics).

The port renders with numpy on the host, one frame at a time (about 3 s for
a 60-frame 320x256 sequence); this copy renders every frame of a sequence in
one batch on the device, in float64 as numpy does, and returns float32
arrays: colors in [0, 1] ``[L, H, W, 3]``, depths ``[L, H, W, 1]``, poses
``[L, 4, 4]`` and the intrinsics ``[4, 4]``. ``test_slambench_harness.py``
holds it equal to the port's frames.
"""

from __future__ import annotations

import math

import torch

BOX = (4.0, 3.0, 5.0)
SPHERES = (
    ((0.65, 0.65, 3.6), 0.45),
    ((3.35, 2.35, 2.1), 0.40),
    ((1.55, 0.55, 4.45), 0.50),
)
DT = 0.08


def intrinsics(height: int, width: int) -> torch.Tensor:
    fx = 0.75 * width
    K = torch.eye(4, dtype=torch.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fx, width / 2.0, height / 2.0
    return K


def poses(frames: torch.Tensor, trajectory: str = "arc") -> torch.Tensor:
    """Camera-to-world poses ``[L, 4, 4]`` (float64, then rounded to
    float32 as the port stores them) of raw frame indices ``frames``."""
    t = frames.to(torch.float64) * DT
    if trajectory == "arc":
        C = torch.stack([2.0 + 0.6 * torch.sin(0.9 * t), 1.5 + 0.10 * torch.sin(1.3 * t),
                         2.5 + 1.7 * torch.sin(0.21 * t)], dim=-1)
    elif trajectory == "revisit":
        C = torch.stack([2.0 + 0.45 * torch.sin(0.9 * t), 1.5 + 0.10 * torch.sin(1.3 * t),
                         2.5 + 1.5 * torch.sin(0.5 * t)], dim=-1)
    else:
        raise ValueError(f"unknown trajectory {trajectory!r}")
    yaw = 0.12 * torch.sin(0.7 * t)
    pitch = 0.05 * torch.sin(1.1 * t)
    cy, sy, cp, sp = torch.cos(yaw), torch.sin(yaw), torch.cos(pitch), torch.sin(pitch)
    zero, one = torch.zeros_like(t), torch.ones_like(t)
    Ry = torch.stack([torch.stack([cy, zero, sy], -1), torch.stack([zero, one, zero], -1),
                      torch.stack([-sy, zero, cy], -1)], -2)
    Rx = torch.stack([torch.stack([one, zero, zero], -1), torch.stack([zero, cp, -sp], -1),
                      torch.stack([zero, sp, cp], -1)], -2)
    T = torch.eye(4, dtype=torch.float64, device=frames.device).repeat(t.shape[0], 1, 1)
    T[:, :3, :3] = Ry @ Rx
    T[:, :3, 3] = C
    return T.to(torch.float32)


def _texture(X: torch.Tensor) -> torch.Tensor:
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    r = 0.5 + 0.20 * torch.sin(3.1 * x + 1.7 * z) + 0.15 * torch.sin(7.3 * y)
    g = 0.5 + 0.20 * torch.sin(2.3 * y + 1.1 * x) + 0.15 * torch.sin(5.9 * z)
    b = 0.5 + 0.20 * torch.sin(2.9 * z + 1.3 * y) + 0.15 * torch.sin(6.7 * x)
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 1.0)


def render(pose32: torch.Tensor, K: torch.Tensor, height: int, width: int):
    """Ray-cast the box interior from each pose ``[L, 4, 4]`` (float32).
    Returns (color ``[L, H, W, 3]``, depth ``[L, H, W, 1]``), float32."""
    dev = pose32.device
    pose = pose32.to(torch.float64)
    Kd = K.to(dev, torch.float64)
    ys, xs = torch.meshgrid(torch.arange(height, device=dev, dtype=torch.float64),
                            torch.arange(width, device=dev, dtype=torch.float64), indexing="ij")
    d_cam = torch.stack([(xs - Kd[0, 2]) / Kd[0, 0], (ys - Kd[1, 2]) / Kd[1, 1],
                         torch.ones_like(xs)], dim=-1)
    R, C = pose[:, :3, :3], pose[:, :3, 3]
    d_w = torch.einsum("hwj,lij->lhwi", d_cam, R)  # d_cam @ R^T per frame
    Cb = C[:, None, None, :]
    best = torch.full(d_w.shape[:3], math.inf, dtype=torch.float64, device=dev)
    for axis in range(3):
        for value in (0.0, BOX[axis]):
            s = (value - Cb[..., axis]) / d_w[..., axis]
            hit = Cb + s[..., None] * d_w
            ok = (s > 1e-6) & torch.isfinite(s)
            for other in range(3):
                if other != axis:
                    ok &= (hit[..., other] >= -1e-6) & (hit[..., other] <= BOX[other] + 1e-6)
            best = torch.where(ok & (s < best), s, best)
    for center, radius in SPHERES:
        oc = Cb - torch.tensor(center, dtype=torch.float64, device=dev)
        b = (d_w * oc).sum(-1)
        c0 = (oc * oc).sum(-1) - radius * radius
        a = (d_w * d_w).sum(-1)
        disc = b * b - a * c0
        sq = disc.clamp(min=0.0).sqrt()
        s1, s2 = (-b - sq) / a, (-b + sq) / a
        s = torch.where(s1 > 1e-6, s1, s2)
        best = torch.where((disc > 0) & (s > 1e-6) & (s < best), s, best)
    best = best.clamp(max=100.0)
    color = _texture(Cb + best[..., None] * d_w)
    return color.to(torch.float32), best.to(torch.float32)[..., None]


def sequence(start: int, frames: int, dilation: int, height: int, width: int, *,
             trajectory: str = "arc", device="cpu"):
    """One window of ``SyntheticDataset(seqlen=frames, dilation=dilation,
    start=start)``: raw frames ``start + k (dilation + 1)``. Returns
    (colors01, depths, K, poses), float32 tensors on ``device``."""
    idx = start + torch.arange(frames, device=device) * (dilation + 1)
    P = poses(idx, trajectory)
    K = intrinsics(height, width).to(device)
    color, depth = render(P, K, height, width)
    return color, depth, K, P
