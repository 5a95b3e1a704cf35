"""Plain PyTorch reference of online adaptation, as the benchmark checks it.

Written from the reference system's description (ivanalberico's
End-To-End-Self-Supervised-SLAM: ``online_adaption.py``, its indoor depth
network, gradslam's PointFusion) and the configurations in
``slambench/configs/``; it imports nothing of the program. Two pieces:

  * ``first_event``: a sequence's keyframe schedule (camera-center
    distance above ``DEMO.frame_threshold``, centers ``-R^T t``, float32)
    and its first event from the seeded weights: R PFT steps on the window
    (frame 0, the first keyframe), target the keyframe: the indoor
    ResNet-18 in ``SETTINGS.compute_dtype`` (float32, or bfloat16 with
    float32 parameters and float32 batch norm), depth ``1 / disp`` with
    online median scaling, view synthesis of the target from frame 0 at the
    dataset's poses, the masked SSIM + L1 photometric loss (the map is
    empty, so the 3D losses are gated off), then Adam. Returns the last
    step's loss and abs_rel and each tensor's first gradient norm.
  * ``last_fusion``: from given weights (a run's final ones), the frame the
    last event fuses: its pair through the network, median-scaled, the
    current keyframe's depth and world points at its pose.

Everything is computed in float32 (the network in its configured dtype).
``quant`` rounds the network's convolution operands: the control's lower
precision.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

ENCODER_CHANNELS = (64, 64, 128, 256, 512)
DECODER_CHANNELS = (16, 32, 64, 128, 256)

SUPPORTED = {  # the settings that change what the check compares: values implemented
    "SETTINGS.compute_dtype": ("float32", "bfloat16"),
    "MODEL.depth_network": ("indoor",),
    "MODEL.num_layers": (18,),
    "MODEL.odom": ("gt",),
    "MODEL.compact_period": (None, 0),
    "MODEL.refinement_mode": (True,),
    "LOSS.geometric": (False,),
    "LOSS.smoothness": (False,),
    "LOSS.depth_regularizer": (False,),
    "LOSS.supervise_depth": (False,),
    "LOSS.auto_masking": (False,),
    "LOSS.min_reprojection": (False,),
    "LOSS.photometric_mask": (True,),
    "ABLATION.scaled_depth": (True,),
    "ABLATION.scale_intrinsics": (False,),
    "ABLATION.dual_disparity": (False,),
    "DATA.use_gt_pose": (True,),
    "OPTIMIZATION.optimizer": ("Adam",),
    "OPTIMIZATION.refinement": ("PFT",),
    "DEMO.sequence_length_refinement": (2, None),
    "MODEL.active_window": (None,),
    "MODEL.fusion_impl": (None, "scatter", "index"),
    "MODEL.index_search_radius": (None, 0),
    "MODEL.index_level2_period": (None, 1),
    "LOSS.knn_impl": ("brute", "index"),
    "LOSS.knn_points": (False, None),
    "LOSS.chamfer_distance": (False,),
    "LOSS.three3d_loss": (True,),
    "LOSS.three3d_query_stride": (None, 1),
    "LOSS.three3d_map_stride": (None, 1),
    "LOSS.three3d_texture_gate": (None,),
    "LOSS.three3d_debias": (None, False),
    "LOSS.three3d_align": (None, "relative"),
    "LOSS.index_assoc_levels": (None, 1, 2),
}


def setting(cfg: Dict, key: str, default=None):
    section, name = key.split(".")
    value = cfg.get(section, {}).get(name, default)
    return default if value is None else value


def check_supported(cfg: Dict) -> None:
    """Raise unless every setting the reference reads has a value it
    implements."""
    bad = []
    for key, allowed in SUPPORTED.items():
        section, name = key.split(".")
        value = cfg.get(section, {}).get(name)
        if value not in allowed:
            bad.append(f"{key}={value!r}")
    if bad:
        raise ValueError("the plain reference does not implement " + ", ".join(bad))


# ---------------------------------------------------------------------------
# the indoor depth network (ResNet-18 encoder, U-Net decoder, 10 sigmoid + 0.01)
# ---------------------------------------------------------------------------

def network_shapes() -> List[tuple]:
    """(name, shape, kind) of every tensor of the indoor ResNet-18 depth
    network, named as its published checkpoints (torchvision's encoder
    names, the decoder's ``ModuleList`` indices); kind is ``conv``,
    ``bias``, ``bn_weight``, ``bn_bias``, ``bn_mean``, ``bn_var`` or
    ``bn_count``."""
    out = []

    def conv(name, cout, cin, k, bias=False):
        out.append((f"{name}.weight", (cout, cin, k, k), "conv"))
        if bias:
            out.append((f"{name}.bias", (cout,), "bias"))

    def bn(name, c):
        out.extend([(f"{name}.weight", (c,), "bn_weight"), (f"{name}.bias", (c,), "bn_bias"),
                    (f"{name}.running_mean", (c,), "bn_mean"),
                    (f"{name}.running_var", (c,), "bn_var"),
                    (f"{name}.num_batches_tracked", (), "bn_count")])

    conv("encoder.conv1", 64, 3, 7)
    bn("encoder.bn1", 64)
    cin = 64
    for stage, width in enumerate((64, 128, 256, 512), start=1):
        for b in range(2):
            p = f"encoder.layer{stage}.{b}"
            conv(f"{p}.conv1", width, cin, 3)
            bn(f"{p}.bn1", width)
            conv(f"{p}.conv2", width, width, 3)
            bn(f"{p}.bn2", width)
            if b == 0 and stage > 1:
                conv(f"{p}.downsample.0", width, cin, 1)
                bn(f"{p}.downsample.1", width)
            cin = width
    for i in range(4, -1, -1):
        c0 = ENCODER_CHANNELS[-1] if i == 4 else DECODER_CHANNELS[i + 1]
        conv(f"decoder.{(4 - i) * 2}.conv.conv", DECODER_CHANNELS[i], c0, 3, bias=True)
        c1 = DECODER_CHANNELS[i] + (ENCODER_CHANNELS[i - 1] if i > 0 else 0)
        conv(f"decoder.{(4 - i) * 2 + 1}.conv.conv", DECODER_CHANNELS[i], c1, 3, bias=True)
    for s in range(4):  # four disparity heads; only scale 0 runs
        conv(f"decoder.{10 + s}.conv", 1, DECODER_CHANNELS[s], 3, bias=True)
    return out


def _const(value: float, dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


class Network:
    """The forward pass over a parameter dict; ``conv_hook(x, w, stride,
    padding)`` may stand in for the convolution (the FLOP counter's).

    With ``groups`` B > 1 every tensor of ``params`` holds B networks
    stacked on a leading axis, and each convolution runs them as one
    grouped convolution over their images side by side in the channels (the
    layout in which a batch of sequences runs its networks together)."""

    def __init__(self, params: Dict[str, Tensor], dtype, quant: Optional[Callable] = None,
                 conv_hook: Optional[Callable] = None, groups: int = 1):
        self.p, self.dtype, self.quant, self.conv_hook = params, dtype, quant, conv_hook
        self.groups = int(groups)

    def flat(self, name):
        t = self.p.get(name)
        if t is None or self.groups == 1:
            return t
        return t.reshape((-1,) + tuple(t.shape[2:]))

    def conv(self, x, name, stride=1, padding=0):
        w = self.flat(f"{name}.weight")
        b = self.flat(f"{name}.bias")
        if self.conv_hook is not None:
            return self.conv_hook(x, w, stride, padding)
        g = self.groups
        if self.dtype == torch.float32 and self.quant is None:
            return F.conv2d(x, w, b, stride, padding, 1, g)
        w = w.to(self.dtype)
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        y = F.conv2d(x, w, None, stride, padding, 1, g)
        return y if b is None else y + b.to(self.dtype).view(1, -1, 1, 1)

    def bn(self, x, name):
        mean, var = self.flat(f"{name}.running_mean"), self.flat(f"{name}.running_var")
        weight, bias = self.flat(f"{name}.weight"), self.flat(f"{name}.bias")
        if x.dtype == torch.float32:
            return F.batch_norm(x, mean, var, weight, bias, False, 0.0, 1e-5)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + 1e-5) * weight
        return ((x.float() - mean.view(shape)) * mul.view(shape) + bias.view(shape)).to(x.dtype)

    def cat(self, a, b):
        """``a`` and ``b`` side by side in each network's own channels."""
        if self.groups == 1:
            return torch.cat([a, b], dim=1)
        n, g = a.shape[0], self.groups
        return torch.cat([a.reshape(n, g, -1, *a.shape[2:]), b.reshape(n, g, -1, *b.shape[2:])],
                         dim=2).reshape(n, -1, *a.shape[2:])

    def __call__(self, images: Tensor) -> Tensor:
        """Images ``[N, H, W, 3]`` in [0, 1] -> disparity ``[N, H, W, 1]``
        float32; with ``groups`` B, ``[B, N, H, W, 3]`` -> ``[B, N, H, W,
        1]``, network ``b`` on images ``b``."""
        dt, g = self.dtype, self.groups
        stacked = images if g > 1 else images[None]
        n, H, W = stacked.shape[1:4]
        x = stacked.permute(1, 0, 4, 2, 3).reshape(n, g * 3, H, W)
        x = (x.to(dt) - _const(0.45, dt)) / _const(0.225, dt)
        feats = [F.relu(self.bn(self.conv(x, "encoder.conv1", 2, 3), "encoder.bn1"))]
        x = F.max_pool2d(feats[0], 3, 2, 1)
        for stage in range(1, 5):
            for b in range(2):
                p = f"encoder.layer{stage}.{b}"
                stride = 2 if (stage > 1 and b == 0) else 1
                out = F.relu(self.bn(self.conv(x, f"{p}.conv1", stride, 1), f"{p}.bn1"))
                out = self.bn(self.conv(out, f"{p}.conv2", 1, 1), f"{p}.bn2")
                if f"{p}.downsample.0.weight" in self.p:
                    x = self.bn(self.conv(x, f"{p}.downsample.0", stride, 0), f"{p}.downsample.1")
                x = F.relu(out + x)
            feats.append(x)
        x = feats[-1]
        for i in range(4, -1, -1):
            x = F.elu(self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"),
                                f"decoder.{(4 - i) * 2}.conv.conv"))
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            if i > 0:
                x = self.cat(x, feats[i - 1])
            x = F.elu(self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"),
                                f"decoder.{(4 - i) * 2 + 1}.conv.conv"))
        head = self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"), "decoder.10.conv")
        disp = 10.0 * torch.sigmoid(head) + _const(0.01, head.dtype)
        disp = disp.reshape(n, g, 1, H, W).permute(1, 0, 3, 4, 2).float()
        return disp if g > 1 else disp[0]


def round_tf32(x: Tensor) -> Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa (to nearest, ties
    to even), as tensor cores read their operands; the gradient passes
    straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return x + (bits.view(torch.float32) - x).detach()


def round_fp8(x: Tensor) -> Tensor:
    """``x`` in float8 e4m3 with one per-tensor scale (its largest
    magnitude to 448), back in ``x``'s dtype; the gradient passes straight
    through."""
    d = x.detach().float()
    scale = d.abs().amax().clamp(min=1e-12) / 448.0
    q = (d / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


CONTROLS = {"tf32": round_tf32, "fp8": round_fp8}


# ---------------------------------------------------------------------------
# geometry, losses, metrics
# ---------------------------------------------------------------------------

def se3_inv(T: Tensor) -> Tensor:
    R, t = T[:3, :3], T[:3, 3:]
    out = torch.eye(4, dtype=T.dtype, device=T.device)
    out[:3, :3] = R.T
    out[:3, 3:] = -(R.T @ t)
    return out


def transform(T: Tensor, pts: Tensor) -> Tensor:
    return pts @ T[:3, :3].T + T[:3, 3]


def camera_points(depth: Tensor, K: Tensor) -> Tensor:
    """Depth ``[H, W, 1]`` -> camera-frame points ``[H, W, 3]``."""
    H, W = depth.shape[:2]
    ys, xs = torch.meshgrid(torch.arange(H, dtype=depth.dtype, device=depth.device),
                            torch.arange(W, dtype=depth.dtype, device=depth.device),
                            indexing="ij")
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    Kinv = torch.stack([torch.stack([1.0 / fx, torch.zeros_like(fx), -cx / fx]),
                        torch.stack([torch.zeros_like(fx), 1.0 / fy, -cy / fy]),
                        torch.stack([torch.zeros_like(fx), torch.zeros_like(fx),
                                     torch.ones_like(fx)])])
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1), torch.ones_like(xs).reshape(-1)])
    rays = Kinv @ pix
    return (rays * depth.reshape(1, -1)).T.reshape(H, W, 3)


def warp_grid(cam: Tensor, K: Tensor, T: Tensor):
    """Project camera points ``[H, W, 3]`` through ``T`` then ``K``: the
    sampling grid in [-1, 1] (normalised by W - 1, H - 1) and validity."""
    H, W = cam.shape[:2]
    P = (K @ T)[:3]
    c = cam.reshape(-1, 3) @ P[:, :3].T + P[:, 3]
    z = c[:, 2:3] + 1e-7
    z = torch.where(z >= 0, z.clamp(min=1e-5), z.clamp(max=-1e-5))
    uv = c[:, :2] / z
    grid = (torch.stack([uv[:, 0] / (W - 1), uv[:, 1] / (H - 1)], -1) - 0.5) * 2.0
    grid = grid.reshape(1, H, W, 2)
    valid = (grid.abs().amax(-1, keepdim=True) <= 1.0).float()
    return grid, valid


def ssim_l1(x: Tensor, y: Tensor) -> Tensor:
    """Per-pixel 0.85 (1 - SSIM) / 2 + 0.15 L1, channel means; NCHW in."""
    xp, yp = F.pad(x, (1, 1, 1, 1), mode="reflect"), F.pad(y, (1, 1, 1, 1), mode="reflect")
    mx, my = F.avg_pool2d(xp, 3, 1), F.avg_pool2d(yp, 3, 1)
    sx = F.avg_pool2d(xp * xp, 3, 1) - mx * mx
    sy = F.avg_pool2d(yp * yp, 3, 1) - my * my
    sxy = F.avg_pool2d(xp * yp, 3, 1) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((1 - (2 * mx * my + c1) * (2 * sxy + c2) / ((mx * mx + my * my + c1)
                                                    * (sx + sy + c2))) / 2).clamp(0, 1)
    return 0.85 * s.mean(1) + 0.15 * (y - x).abs().mean(1)


def median(x: Tensor) -> Tensor:
    """Mean of the two middle values (numpy's median)."""
    s = x.reshape(-1).sort().values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def keyframe_schedule(poses: np.ndarray, threshold: float):
    """(previous, current) keyframe pairs by camera-center distance."""
    R, t = poses[..., :3, :3], poses[..., :3, 3]
    centers = -np.einsum("...ij,...i->...j", R, t)
    events, prev = [], 0
    for frame in range(1, len(centers)):
        if np.linalg.norm(centers[frame] - centers[prev]) > threshold:
            events.append((prev, frame))
            prev = frame
    return events


class Adam:
    """Adam (Kingma and Ba; betas 0.9, 0.999, eps 1e-8) over the tensors
    that receive a gradient, from the moments ``m``, ``v``, the update
    count ``t`` and the learning-rate count ``count`` it is given."""

    def __init__(self, lr_at: Callable[[int], float], m=None, v=None, t: int = 0,
                 count: int = 0):
        self.lr_at, self.t, self.count = lr_at, int(t), int(count)
        self.m, self.v = dict(m or {}), dict(v or {})

    def step(self, params: Dict[str, Tensor], grads: Dict[str, Tensor],
             keep: Optional[Tensor] = None) -> None:
        """One update; ``keep`` (bool ``[B]``, stacked tensors) marks rows
        that take none: their tensors and moments stay as they were."""
        lr = self.lr_at(self.count)
        self.count += 1
        self.t += 1
        b1, b2 = 0.9, 0.999
        for k, g in grads.items():
            m = b1 * self.m.get(k, torch.zeros_like(g)) + (1 - b1) * g
            v = b2 * self.v.get(k, torch.zeros_like(g)) + (1 - b2) * g * g
            denom = v.sqrt() / math.sqrt(1 - b2 ** self.t) + 1e-8
            new = (params[k] - (lr / (1 - b1 ** self.t)) * m / denom).detach()
            if keep is not None:
                rows = keep.view((-1,) + (1,) * (g.dim() - 1))
                new = torch.where(rows, params[k], new)
                m = torch.where(rows, self.m.get(k, torch.zeros_like(g)), m)
                v = torch.where(rows, self.v.get(k, torch.zeros_like(g)), v)
            params[k], self.m[k], self.v[k] = new, m, v


def lr_schedule(cfg: Dict) -> Callable[[int], float]:
    lr = float(setting(cfg, "OPTIMIZATION.learning_rate"))
    kind = setting(cfg, "OPTIMIZATION.schedular", "none")
    gamma = float(setting(cfg, "OPTIMIZATION.schedular_gamma", 1.0))
    if kind == "StepLR":
        size = int(setting(cfg, "OPTIMIZATION.schedular_step_size"))
        return lambda t: lr * gamma ** (t // size)
    if kind == "MultiStepLR":
        marks = [int(x) for x in setting(cfg, "OPTIMIZATION.schedular_milestones")]
        return lambda t: lr * gamma ** sum(t >= x for x in marks)
    if kind == "ExponentialLR":
        return lambda t: lr * gamma ** t
    return lambda t: lr


def trainable_names() -> List[str]:
    """The tensors the refinement trains: every convolution's kernel and
    bias but those of the three disparity heads that never run (batch norm
    stays frozen)."""
    return [k for k, _, kind in network_shapes()
            if kind in ("conv", "bias") and not k.startswith(("decoder.11", "decoder.12",
                                                                "decoder.13"))]


def first_event(cfg: Dict, weights: Dict[str, Tensor], colors: Tensor, depths: Tensor,
                K: Tensor, poses: Tensor, quant: Optional[Callable] = None) -> Dict:
    """The sequence (colors ``[L, H, W, 3]`` in [0, 1], depths ``[L, H, W,
    1]``, ``K`` ``[4, 4]``, poses ``[L, 4, 4]``, float32 on one device):
    {"schedule": [(prev, cur), ...], "row": {total_loss, abs_rel} of the
    first event's last step, before its update, "first_grad_norms": each
    tensor's gradient norm at the first step}."""
    check_supported(cfg)
    dtype = getattr(torch, setting(cfg, "SETTINGS.compute_dtype"))
    R = int(setting(cfg, "OPTIMIZATION.refinement_steps"))
    schedule = keyframe_schedule(poses.cpu().numpy(), float(setting(cfg, "DEMO.frame_threshold")))
    prev, cur = schedule[0]
    params = {k: v.detach().clone() for k, v in weights.items()}
    trainable = trainable_names()
    adam = Adam(lr_schedule(cfg))
    T_src = se3_inv(poses[prev]) @ poses[cur]
    target = colors[cur][None].permute(0, 3, 1, 2)
    first_grads, row = {}, {}
    for step in range(R):
        p = {k: (v.requires_grad_(True) if k in trainable else v) for k, v in params.items()}
        depth = scaled_depth(cfg, p, dtype, colors, depths, [prev, cur], quant)
        grid, valid = warp_grid(camera_points(depth[1], K), K, T_src)
        synth = F.grid_sample(colors[prev][None].permute(0, 3, 1, 2), grid, mode="bilinear",
                              padding_mode="border", align_corners=False)
        vm = valid.permute(0, 3, 1, 2)
        loss = ssim_l1(synth * vm, target * vm).mean()
        grads = torch.autograd.grad(loss, [p[k] for k in trainable], allow_unused=True)
        with torch.no_grad():
            g = depths[cur].reshape(-1)
            d = depth[1].detach().reshape(-1)
            row = {"total_loss": float(loss), "abs_rel": float(((g - d).abs() / g).mean())}
        if step == 0:
            first_grads = {k: float(gr.norm()) for k, gr in zip(trainable, grads)
                           if gr is not None}
        adam.step(params, {k: gr for k, gr in zip(trainable, grads) if gr is not None})
    return {"schedule": schedule, "row": row, "first_grad_norms": first_grads}


def scaled_depth(cfg: Dict, params, dtype, colors: Tensor, depths: Tensor, frames,
                 quant: Optional[Callable] = None) -> Tensor:
    """The depth of ``frames`` through the network, ``1 / disp``, scaled by
    the ratio of the ground truth's median to its own over both frames
    (every ``ABLATION.median_stride``-th pixel)."""
    ms = int(setting(cfg, "ABLATION.median_stride", 1))
    depth = 1.0 / Network(params, dtype, quant)(colors[frames])
    g = depths[frames]
    return depth * (median(g[:, ::ms, ::ms]) / median(depth[:, ::ms, ::ms]))


# ---------------------------------------------------------------------------
# one keyframe event from a given state: the 3D point loss and fusion
# ---------------------------------------------------------------------------

def project(points: Tensor, pose: Tensor, K: Tensor, H: int, W: int):
    """World points ``[N, 3]`` into the camera at ``pose`` (camera to
    world): (pixel id ``[N]``, clamped into the image; in the image and in
    front of the camera ``[N]``), the pixel the nearest to the projection."""
    c = transform(se3_inv(pose), points)
    z = c[:, 2]
    zs = torch.where(z.abs() > 1e-8, z, torch.full_like(z, 1e-8))
    u = torch.round(K[0, 0] * c[:, 0] / zs + K[0, 2]).long()
    v = torch.round(K[1, 1] * c[:, 1] / zs + K[1, 2]).long()
    inside = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (z > 0)
    return v.clamp(0, H - 1) * W + u.clamp(0, W - 1), inside


def nearest(q: Tensor, m: Tensor, block_q: int = 1024, block_m: int = 1 << 20) -> Tensor:
    """Index of each query's nearest point of ``m`` ``[M, 3]``, by every
    distance, in float64 (the lowest index of equal ones)."""
    q, m = q.double(), m.double()
    m_sq = (m * m).sum(dim=1)
    out = torch.empty(q.shape[0], dtype=torch.long, device=q.device)
    for i in range(0, q.shape[0], block_q):
        qb = q[i:i + block_q]
        best_v, best_i = None, None
        for j in range(0, m.shape[0], block_m):
            # |m|^2 - 2 q.m: the distance less |q|^2, which a query's row shares.
            d = torch.addmm(m_sq[j:j + block_m][None], qb, m[j:j + block_m].T, alpha=-2.0)
            v, k = d.min(dim=1)
            if best_v is None:
                best_v, best_i = v, k
            else:
                better = v < best_v
                best_v = torch.where(better, v, best_v)
                best_i = torch.where(better, k + j, best_i)
        out[i:i + block_q] = best_i
    return out


def normals(cam: Tensor) -> Tensor:
    """Per-pixel normals of camera points ``[H, W, 3]``: the normalised
    cross product of the forward differences along x and y; the last row
    and column, which have none, get a zero normal."""
    dx = torch.zeros_like(cam)
    dy = torch.zeros_like(cam)
    dx[:, :-1] = cam[:, 1:] - cam[:, :-1]
    dy[:-1] = cam[1:] - cam[:-1]
    n = torch.cross(dx, dy, dim=-1)
    n2 = (n * n).sum(dim=-1, keepdim=True)
    return torch.where(n2 > 1e-24, n / n2.clamp(min=1e-30).sqrt(), torch.zeros_like(n))


def live_frame(depth: Tensor, color: Tensor, K: Tensor, pose: Tensor, sigma: float) -> Dict:
    """A frame's pixels as the map's rows would hold them, flat ``[H*W,
    ...]``: world points and normals, colors, validity (depth above 0) and
    the measurement confidence (a Gaussian of the pixel's radius from the
    principal point, normalised by the principal point's own radius)."""
    H, W = depth.shape[:2]
    cam = camera_points(depth, K)
    R = pose[:3, :3]
    valid = depth.reshape(-1) > 0
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=depth.device),
                            torch.arange(W, dtype=torch.float32, device=depth.device),
                            indexing="ij")
    cx, cy = K[0, 2], K[1, 2]
    r2 = ((xs - cx) ** 2 + (ys - cy) ** 2) / (cx ** 2 + cy ** 2 + 1e-12)
    alpha = torch.exp(-r2 / (2.0 * sigma ** 2)).reshape(-1) * valid
    return {"points": transform(pose, cam.reshape(-1, 3)),
            "normals": normals(cam).reshape(-1, 3) @ R.T,
            "colors": color.reshape(-1, 3), "valid": valid, "alpha": alpha}


def index_slots(m: Dict, points: Tensor, valid: Tensor, K: Tensor, H: int, W: int,
                levels: int) -> tuple:
    """Each point's map slot through the map's index images: the slot the
    last fused keyframe saw at the pixel the point projects to, and where
    it saw none and ``levels`` is 2, the older keyframe's. Returns (slot,
    found)."""
    def lookup(image, pose):
        pix, inside = project(points, pose, K, H, W)
        slot = image.long()[pix]
        return slot, inside & (slot >= 0) & valid

    slot, found = lookup(m["index_image"], m["index_pose"])
    if levels >= 2 and m.get("index_image2") is not None:
        slot2, found2 = lookup(m["index_image2"], m["index_pose2"])
        slot = torch.where(found, slot, slot2)
        found = found | found2
    return slot.clamp(0, m["data"].shape[0] - 1), found


def point_loss(cfg: Dict, depth: Tensor, K: Tensor, pose_prev: Tensor, pose: Tensor,
               m: Dict) -> Tensor:
    """The three3d loss of the target frame's depth ``[H, W, 1]`` against
    the map ``m``: its world points, moved by the target-to-source
    transform, against each one's neighbour in the map (the nearest map
    point for ``knn_impl: brute``; the slot of the index image for
    ``index``, gated at ``three3d_dist_gate`` and weighted by the slot's
    confidence when the configuration says so): the weighted mean squared
    distance, 0 on an empty map."""
    H, W = depth.shape[:2]
    count = int(m["count"])
    world = transform(pose, camera_points(depth, K).reshape(-1, 3))
    w = (depth.reshape(-1) > 0).to(depth.dtype)
    pts = transform(se3_inv(pose_prev) @ pose, world)
    if setting(cfg, "LOSS.knn_impl", "brute") == "brute":
        mp = m["data"][:count, 0:3]
        nn = mp[nearest(pts.detach(), mp)] if count else torch.zeros_like(pts)
    else:
        levels = int(setting(cfg, "LOSS.index_assoc_levels", 2))
        slot, found = index_slots(m, world.detach(), w > 0, K, H, W, levels)
        rows = m["data"][slot]
        nn = rows[:, 0:3]
        w = w * found.to(w.dtype)
        gate = setting(cfg, "LOSS.three3d_dist_gate")
        if gate:
            w = w * (((pts.detach() - nn) ** 2).sum(dim=-1) < float(gate) ** 2).to(w.dtype)
        if setting(cfg, "LOSS.three3d_conf_weight", False):
            w = w * rows[:, 9].clamp(max=4.0) * 0.25
    loss = (w * ((pts - nn) ** 2).sum(dim=-1)).sum() / w.sum().clamp(min=1.0)
    return loss * (1.0 if count > 0 else 0.0)


def event_loss(cfg: Dict, depth: Tensor, frames: Tensor, gts: Tensor, K: Tensor, poses: Tensor,
               m: Dict) -> tuple:
    """The loss of one sequence's window (previous, current keyframe:
    ``depth`` ``[2, H, W, 1]`` scaled, ``frames``, ``gts``, ``poses``):
    the masked photometric loss of the current frame synthesised from the
    previous one, plus the weighted three3d loss. Returns (loss, {"total_loss",
    "photometric", "three3d", "abs_rel"})."""
    T_src = se3_inv(poses[0]) @ poses[1]
    grid, valid = warp_grid(camera_points(depth[1], K), K, T_src)
    synth = F.grid_sample(frames[0][None].permute(0, 3, 1, 2), grid, mode="bilinear",
                          padding_mode="border", align_corners=False)
    vm = valid.permute(0, 3, 1, 2)
    target = frames[1][None].permute(0, 3, 1, 2)
    photo = ssim_l1(synth * vm, target * vm).mean()
    three3d = point_loss(cfg, depth[1], K, poses[0], poses[1], m)
    loss = photo + float(setting(cfg, "LOSS.three3d_loss_weight")) * three3d
    with torch.no_grad():
        g, d = gts[1].reshape(-1), depth[1].detach().reshape(-1)
        row = {"total_loss": float(loss), "photometric": float(photo),
               "three3d": float(three3d), "abs_rel": float(((g - d).abs() / g).mean())}
    return loss, row


def forward(params: Dict[str, Tensor], dtype, frames: Tensor, quant=None) -> Tensor:
    """Disparity ``[B, 2, H, W, 1]`` of each sequence's frames ``[B, 2, H,
    W, 3]`` through its own network (``params`` stacked ``[B, ...]``): one
    network called alone, several as one grouped network."""
    B = frames.shape[0]
    if B == 1:
        return Network({k: v[0] for k, v in params.items()}, dtype, quant)(frames[0])[None]
    return Network(params, dtype, quant, groups=B)(frames)


def scale(cfg: Dict, depth: Tensor, gts: Tensor) -> Tensor:
    """Online median scaling of a window's depth over its frames (every
    ``ABLATION.median_stride``-th pixel)."""
    ms = int(setting(cfg, "ABLATION.median_stride", 1))
    return depth * (median(gts[:, ::ms, ::ms]) / median(depth[:, ::ms, ::ms]))


def follow_event(cfg: Dict, state: Dict, frames: Tensor, gts: Tensor, K: Tensor,
                 poses: Tensor, active: List[bool], quant: Optional[Callable] = None) -> Dict:
    """One keyframe event of B sequences from ``state`` (``weights``
    ``{name: [B, ...]}``, ``moments`` ``{name: (m, v)}`` of the tensors
    Adam steps, ``adam_step``, ``lr_count``, ``maps``: per sequence
    ``data`` ``[N, 16]`` (points, normals, colors, confidence), ``count``
    and its index images and poses): R steps on each sequence's window
    (``frames``, ``gts`` ``[B, 2, H, W, ...]``, ``K`` ``[B, 4, 4]``, ``poses``
    ``[B, 2, 4, 4]``), the losses summed over the ``active`` sequences, then
    Adam on the active rows. Returns {"rows": per sequence the last step's
    ``event_loss`` row, "weights": the tensors after the updates,
    "grad_norms": per sequence each stepped tensor's gradient norm at the
    first step}."""
    check_supported(cfg)
    dtype = getattr(torch, setting(cfg, "SETTINGS.compute_dtype"))
    R = int(setting(cfg, "OPTIMIZATION.refinement_steps"))
    B = frames.shape[0]
    params = {k: v.detach().clone() for k, v in state["weights"].items()}
    stepped = trainable_names()
    adam = Adam(lr_schedule(cfg), m={k: mv[0] for k, mv in state["moments"].items()},
                v={k: mv[1] for k, mv in state["moments"].items()},
                t=int(state["adam_step"]), count=int(state["lr_count"]))
    keep = ~torch.tensor([bool(a) for a in active], device=frames.device)
    rows, norms = [None] * B, None
    for step in range(R):
        p = {k: (v.requires_grad_(True) if k in stepped else v) for k, v in params.items()}
        depth = 1.0 / forward(p, dtype, frames, quant)
        total = 0.0
        for b in range(B):
            loss, rows[b] = event_loss(cfg, scale(cfg, depth[b], gts[b]), frames[b], gts[b],
                                       K[b], poses[b], state["maps"][b])
            if active[b]:
                total = total + loss
        grads = torch.autograd.grad(total, [p[k] for k in stepped], allow_unused=True)
        grads = {k: g for k, g in zip(stepped, grads) if g is not None}
        if step == 0:
            norms = [{k: float(g[b].norm()) for k, g in grads.items()} for b in range(B)]
        adam.step(params, grads, keep=keep)
    return {"rows": rows, "weights": params, "grad_norms": norms}


def fused_depth(cfg: Dict, weights: Dict[str, Tensor], frames: Tensor, gts: Tensor,
                quant: Optional[Callable] = None) -> Tensor:
    """The scaled depth ``[B, H, W, 1]`` of each sequence's current frame
    that fusion takes: the window through the networks ``weights`` (after
    the event's updates), median-scaled over both frames."""
    dtype = getattr(torch, setting(cfg, "SETTINGS.compute_dtype"))
    with torch.no_grad():
        depth = 1.0 / forward(weights, dtype, frames, quant)
        return torch.stack([scale(cfg, depth[b], gts[b])[1] for b in range(frames.shape[0])])


def fuse(cfg: Dict, m: Dict, depth: Tensor, color: Tensor, K: Tensor, pose: Tensor) -> Dict:
    """PointFusion of a frame (``depth`` ``[H, W, 1]``, ``color``, ``K``,
    camera-to-world ``pose``) into the map ``m``, as gradslam fuses surfels:
    each valid pixel's point is matched with a map point (``scatter``: the
    map points that project onto the pixel, the closest within
    ``MODEL.dist_th`` whose normal lies within ``MODEL.angle_th``, the
    lowest row of equal ones; ``index``: the slot the map's index images
    give it, under the same two gates, the highest pixel winning a slot
    that several match), a matched point takes the confidence-weighted mean
    of itself and the pixel (its normal renormalised, its confidence the
    sum), and each valid pixel not matched is appended, in pixel order.
    Returns {"data", "count", "merged": the rows below the old count that
    changed, "appended": the appended pixels in row order}."""
    H, W = depth.shape[:2]
    N = m["data"].shape[0]
    count = int(m["count"])
    th = float(setting(cfg, "MODEL.dist_th"))
    cos_th = float(torch.cos(torch.deg2rad(torch.tensor(float(setting(cfg, "MODEL.angle_th"))))))
    live = live_frame(depth, color, K, pose, float(setting(cfg, "MODEL.sigma")))
    data = m["data"].clone()
    if setting(cfg, "MODEL.fusion_impl", "scatter") == "index":
        slot, found = index_slots(m, live["points"], live["valid"], K, H, W, 2)
        old = data[slot]
        ok = found & ((live["points"] - old[:, 0:3]).norm(dim=-1) < th)
        ok &= (live["normals"] * old[:, 3:6]).sum(dim=-1) > cos_th
        px = ok.nonzero()[:, 0].flip(0)  # the highest pixel first
        px = px[torch.argsort(slot[px], stable=True)]
        first = torch.ones_like(px, dtype=torch.bool)
        first[1:] = slot[px][1:] != slot[px][:-1]
        px = px[first]
        rows = slot[px]
        claimed = ok
    else:
        P = data[:count]
        pix, inside = project(P[:, 0:3], pose, K, H, W)
        ok = inside & live["valid"][pix]
        dist = (P[:, 0:3] - live["points"][pix]).norm(dim=-1)
        ok &= dist < th
        ok &= (P[:, 3:6] * live["normals"][pix]).sum(dim=-1) > cos_th
        rows = ok.nonzero()[:, 0]
        rows = rows[torch.argsort(dist[rows], stable=True)]
        rows = rows[torch.argsort(pix[rows], stable=True)]
        first = torch.ones_like(rows, dtype=torch.bool)
        first[1:] = pix[rows][1:] != pix[rows][:-1]
        rows = rows[first]
        px = pix[rows]
        claimed = torch.zeros(H * W, dtype=torch.bool, device=data.device)
        claimed[px] = True
    c, a = data[rows, 9], live["alpha"][px]
    wsum = (c + a).clamp(min=1e-12)

    def blend(old, new):
        return (c[:, None] * old + a[:, None] * new) / wsum[:, None]

    n = blend(data[rows, 3:6], live["normals"][px])
    n2 = (n * n).sum(dim=-1, keepdim=True)
    n = torch.where(n2 > 1e-24, n / n2.clamp(min=1e-30).sqrt(), n)
    merged_rows = torch.cat([blend(data[rows, 0:3], live["points"][px]), n,
                             blend(data[rows, 6:9], live["colors"][px]), (c + a)[:, None]], dim=1)
    data[rows, 0:10] = merged_rows
    merged = torch.zeros(count, dtype=torch.bool, device=data.device)
    merged[rows] = True
    new = (live["valid"] & ~claimed).nonzero()[:, 0][: max(N - count, 0)]
    data[count:count + new.shape[0], 0:10] = torch.cat(
        [live["points"][new], live["normals"][new], live["colors"][new],
         live["alpha"][new][:, None]], dim=1)
    return {"data": data, "count": count + new.shape[0], "merged": merged, "appended": new}


def flops_per_event(height: int, width: int, frames: int = 2, steps: int = 3) -> float:
    """Model FLOPs of one keyframe event: ``steps`` forward and backward
    passes (the backward twice the forward) and one forward for fusion,
    each over ``frames`` images, 2 FLOPs a multiply-add of every
    convolution; no recomputation."""
    return 2.0 * conv_macs(height, width, frames) * (3 * steps + 1)


def conv_macs(height: int, width: int, frames: int = 2) -> float:
    """Multiply-adds of the network's convolutions on ``frames`` images,
    from their shapes (a pass over shape-only tensors)."""
    total = [0.0]

    def hook(x, w, stride, padding):
        n, _, h, wd = x.shape
        cout, cin, k, _ = w.shape
        ho = (h + 2 * padding - k) // stride + 1
        wo = (wd + 2 * padding - k) // stride + 1
        total[0] += float(n * cout * ho * wo * cin * k * k)
        return torch.empty(n, cout, ho, wo, device="meta")

    params = {k: torch.empty(s, device="meta") for k, s, _ in network_shapes()}
    Network(params, torch.float32, conv_hook=hook)(
        torch.empty(frames, height, width, 3, device="meta"))
    return total[0]
