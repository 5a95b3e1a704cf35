"""The refinement engine: one PFT gradient step, and fusion of a refined pair.

The PFT path of ``e2eslam_tpu/engine/refine.py``: per keyframe window, R
steps of parameter fine-tuning (PFT) of the depth network -- batched depth
forward (indoor or monodepth2, optionally the dual-disparity blend), depth
scaling, view synthesis with the dataset's poses or, with
``DATA.use_gt_pose: false``, poses estimated by ICP on the predicted depths
inside the step, then the loss family of
``RefinementEngine._assemble_losses``: the photometric loss (masked,
auto-masked, min-reprojection), the geometric, smoothness,
depth-regularizer and sparse-supervision terms, and the end-to-end 3D point
losses against the global map (three3d or its ``knn_points`` alias, and the
bidirectional chamfer) -- then fusion of the newest keyframe pair into the
map at the configured odometry's pose. The 3D losses find their neighbours
by the exact brute-force KNN (``LOSS.knn_impl: brute``), through the last
fused keyframe's cached index image (``index``, with ``MODEL.fusion_impl:
index``), by projecting the map onto the frame (``projective``), or in a
voxel hash of the map (``voxel``); only the brute search launches a KNN
kernel.

The brute 3D losses thread warm starts through a keyframe's steps as the JAX
``process_pair`` does: step 0 of the frame->map searches is seeded by a
strided KNN over the map's newest rows (``tail_seed``), the chamfer's
map->frame search by the pixel each map point projects to; steps 1..R-1
take the previous step's indices, and the query Morton permutation computed
at step 0 is reused. The adaptation loop may seed step 0 with the previous
keyframe's final indices instead. Every seed is re-scored inside
``ops.knn``, so the search stays exact.

Randomness (``supervise_depth``'s sampler, the tie-break noise of
``auto_masking`` with ``min_reprojection``) comes from one
``torch.Generator`` on the engine's device, seeded from
``SETTINGS.seed`` (default 1, the JAX runner's key): JAX's threefry stream
has no torch counterpart, so those draws match the JAX package's in
distribution only.

The whole-sequence program (``process_sequence``, the JAX engine's
``_make_process_sequence``, refine.py:1277-1405) runs a run's whole keyframe
schedule, E events of R PFT steps and fusion, with no read from the device
to the host: the map's count, the cross-keyframe KNN cache, the learning
rate and each event's metrics stay on the device. On the CPU its events run
eagerly. On a CUDA card with at least three events (``event_schedule``)
event 0 runs eagerly on a side stream (it sets up cuDNN, autograd and the
optimizer's state), event 1 is captured as a CUDA graph into the process's
graph pool (``capture_graph``: no synchronisation and no flush of the
allocators' caches), and events 1 to E-1 are its replays, fed their frame
indices from pinned host memory; a periodic
compaction pass (``slam/compact.py``, fixed-shape) is launched between
replays over a bucket of rows chosen from a host bound on the count, with
no read. Every KNN launch inside the graph reads its valid counts on the
device (``ops/knn.py``). With the observability outputs on
(``VIZ.log_gradients``, ``DEBUG.plot``) each event's gradient norms and
debug images go into the program's buffers beside its scalars
(``event_rows``), as the JAX program stacks them.

Beside the PFT step, the offline apps' modes (``refine.py:1410-1537``):
output fine-tuning (``oft_step``, ``oft_window``: Adam on the depth maps
themselves, the network frozen), the learned affine scale (``scale_step``:
Adam on a global scale and bias only), the observability step
(``refine_step_with_grads``: per-layer gradient norms, the decoder's
activation gradients, the debug images) and the inference forward
(``predict_depth``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from e2eslam_tpu_torch.core.camera import inverse_intrinsics, normalize_intrinsics
from e2eslam_tpu_torch.core.depth import disp_to_depth, indoor_disp_to_depth, scale_by_focal
from e2eslam_tpu_torch.core.projection import backproject, project
from e2eslam_tpu_torch.core.sampling import grid_sample
from e2eslam_tpu_torch.core.se3 import se3_inverse, transform_points
from e2eslam_tpu_torch.engine.optim import DeviceSchedule, make_optimizer
from e2eslam_tpu_torch.losses.metrics import depth_metrics
from e2eslam_tpu_torch.losses.photometric import photometric_loss
from e2eslam_tpu_torch.losses.points import knn_points_loss, texture_gate
from e2eslam_tpu_torch.losses.regularizers import (
    depth_gt_loss,
    depth_regularizer,
    disparity_smoothness_loss,
    geometric_consistency_loss,
    sparse_sampling,
)
from e2eslam_tpu_torch.models.decoders import decoder_tap_shapes
from e2eslam_tpu_torch.ops.knn import is_device_count, knn
from e2eslam_tpu_torch.ops.spatial_sort import SortedMap, morton_codes, sort_map_points
from e2eslam_tpu_torch.ops.voxel_knn import build_voxel_index, voxel_knn
from e2eslam_tpu_torch.slam.compact import compact_map, compact_map_projective
from e2eslam_tpu_torch.slam.fusion import (
    _project_pixels,
    frame_pointcloud,
    index_nn,
    projective_nn,
)
from e2eslam_tpu_torch.slam.odometry import point_to_plane_icp
from e2eslam_tpu_torch.slam.pointclouds import MapState, empty_map, on_device
from e2eslam_tpu_torch.slam.rgbd import build_frame, normal_map
from e2eslam_tpu_torch.slam.slam import PointFusion
from e2eslam_tpu_torch.utils import tracing

Tensor = torch.Tensor

TARGET = 1  # target-frame index within a window (reference convention)

# Invalid frame pixels of the chamfer's map->frame search sit here: far
# outside any scene, yet small enough to keep the kernels' float32 scores
# and boxes usable (e2eslam_tpu/engine/refine.py:812-817).
INVALID_SENTINEL = 1e4


class PairBatch(NamedTuple):
    """One adaptation window of F frames."""

    colors: Tensor  # [F, H, W, 3] in [0, 1]
    gt_depths: Tensor  # [F, H, W, 1]
    intrinsics: Tensor  # [4, 4]
    poses: Tensor  # [F, 4, 4]


KNN_IMPLS = ("brute", "index", "projective", "voxel")

COMPACT_QUANTUM = 1 << 20  # compaction's bucket ladder (refine.py:1317-1349)


def compact_bucket(count: int, capacity: int) -> int:
    """The rows a compaction pass runs over: ``count`` rounded up to
    COMPACT_QUANTUM rows, at most ``capacity`` (all valid rows live there)."""
    return min(-(-max(count, 1) // COMPACT_QUANTUM) * COMPACT_QUANTUM, capacity)


REFINEMENTS = ("PFT", "OFT", "SCALE")


def validate_config(config) -> None:
    """Refuse settings whose code paths the port does not carry
    (``compute_dtype`` other than float32 and bfloat16), a ``knn_impl``,
    ``fusion_impl``, ``compact_mode`` or ``refinement`` the JAX package
    lacks too, and its inconsistent pair
    (``e2eslam_tpu/engine/refine.py:149-163``). ``OPTIMIZATION.refinement``
    names the mode an app runs: the online loop runs PFT, OFT and SCALE run
    through ``apps.train_depth_oft`` and ``apps.absolute_scale``."""
    L, M, O = config.LOSS, config.MODEL, config.OPTIMIZATION
    impl = str(L.get("knn_impl", "brute"))
    if impl == "index" and str(M.get("fusion_impl", "scatter")) != "index":
        raise ValueError(
            "LOSS.knn_impl: index requires MODEL.fusion_impl: index (the fusion step "
            "maintains the index image the association reads)")
    bad = []
    if impl not in KNN_IMPLS:
        bad.append(f"LOSS.knn_impl={impl!r} (one of {KNN_IMPLS})")
    if str(M.get("fusion_impl", "scatter")) not in ("scatter", "index"):
        bad.append(f"MODEL.fusion_impl={M.get('fusion_impl')!r} (only scatter and index)")
    if str(M.get("compact_mode", "voxel") or "voxel") not in ("voxel", "projective"):
        raise ValueError(f"MODEL.compact_mode must be voxel or projective, got "
                         f"{M.get('compact_mode')!r}")
    if str(O.get("refinement", "PFT")) not in REFINEMENTS:
        bad.append(f"OPTIMIZATION.refinement={O.get('refinement')!r} (one of {REFINEMENTS})")
    if str(config.SETTINGS.get("compute_dtype", "float32")) not in ("float32", "bfloat16"):
        bad.append("SETTINGS.compute_dtype (float32 or bfloat16)")
    if bad:
        raise NotImplementedError(
            "not ported to e2eslam_tpu_torch yet: " + ", ".join(bad))


def _merge_dual_disparity(left: Tensor, right: Tensor) -> Tensor:
    """Blend the forward and flipped disparities with edge ramps. The ramp
    runs along WIDTH, as the JAX package intends (refine.py:66-80; the
    reference's mask ramps along height, a meshgrid quirk)."""
    W = left.shape[2]
    x = torch.linspace(0.0, 1.0, W, dtype=left.dtype, device=left.device).reshape(1, 1, W, 1)
    l_mask = 1.0 - (20.0 * (x - 0.05)).clamp(0.0, 1.0)
    r_mask = l_mask.flip(2)
    middle = 0.5 * (left + right)
    return r_mask * left + l_mask * right + (1.0 - l_mask - r_mask) * middle


def _median(x: Tensor) -> Tensor:
    """``jnp.median``: the mean of the two middle values for an even count
    (``torch.median`` returns the lower one). Differentiable."""
    s = x.reshape(-1).sort().values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def masked_point_loss(pts: Tensor, nn_pts: Tensor, w: Tensor, scale: Optional[Tensor] = None,
                      debias: bool = False) -> Tensor:
    """``sum(w * |pts - nn|^2) / max(sum w, 1)``, the shared reduction of
    the JAX engine's 3D losses (``_masked_point_loss``, refine.py:115-146).

    ``scale`` [N] multiplies the numerator only (the texture gate: the loss
    shrinks where it applies instead of renormalising). ``debias``
    (``LOSS.three3d_debias``) first subtracts the weighted mean residual
    vector, detached: the rigid offset of a misregistered keyframe."""
    r = pts - nn_pts
    wsum = w.sum().clamp(min=1.0)
    if debias:
        r = r - ((r * w[:, None]).sum(dim=0) / wsum).detach()
    d2 = (r * r).sum(dim=-1) * w
    if scale is not None:
        d2 = d2 * scale
    return d2.sum() / wsum


def empty_map_gate(count, dtype=torch.float32):
    """The 3D losses' empty-map gate: 1 when the map holds a point, else 0
    (a python float for an int count; a 0-d tensor, with no host read, for
    a device count)."""
    if is_device_count(count):
        return (count > 0).to(dtype)
    return 1.0 if count > 0 else 0.0


class OFTState(NamedTuple):
    """Output fine-tuning's variable and its optimizer: the depth maps
    ``[F, H, W, 1]`` (a leaf that requires grad) and a fresh optimizer and
    schedule over them (``e2eslam_tpu/engine/refine.py:1464``)."""

    depths: Tensor
    optimizer: torch.optim.Optimizer
    scheduler: object


class ScaleState(NamedTuple):
    """The learned affine scale: ``params`` ``{"scale"[, "bias"]}`` (0-d
    leaves that require grad) and their optimizer and schedule."""

    params: Dict[str, Tensor]
    optimizer: torch.optim.Optimizer
    scheduler: object


class RefinementEngine:
    """Owns the depth network, its optimizer, the random generator and the
    SLAM front end."""

    def __init__(self, config, model: nn.Module, *, map_capacity: int,
                 device: torch.device):
        validate_config(config)
        self.config = config
        self.device = device
        self.model = model.to(device)
        self.map_capacity = int(map_capacity)
        if config.MODEL.refinement_mode:
            # Frozen batch norm: without gradients Adam leaves these
            # parameters exactly where they are, as optax does with the
            # JAX engine's zero-masked gradients.
            for m in self.model.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.requires_grad_(False)
        trainable = [p for p in self.model.parameters() if p.requires_grad]
        # optax's SGD decays every parameter, whatever its gradient: the JAX
        # engine masks the frozen ones' gradients to zero (refine.py:974-976)
        # and unused heads get zero gradients, so the SGD here steps every
        # parameter, a zero gradient standing in for a missing one.
        self._zero_grads = (list(self.model.parameters())
                            if config.OPTIMIZATION.optimizer == "SGD" else [])
        self.optimizer, self.scheduler = make_optimizer(config, self._zero_grads or trainable)
        M = config.MODEL
        aw = M.get("active_window")
        self.active_window = int(aw) if aw else None
        self.slam = PointFusion(
            odom=str(M.odom), dist_th=float(M.dist_th), angle_th=float(M.angle_th),
            sigma=float(M.sigma), numiters=int(M.numiters), active_window=self.active_window,
            fusion_impl=str(M.get("fusion_impl", "scatter")),
            index_levels=int(M.get("index_levels", 1) or 1),
            index_level2_period=int(M.get("index_level2_period", 1) or 1),
            index_search_radius=int(M.get("index_search_radius", 0) or 0))
        L = config.LOSS
        self.refinement_steps = int(config.OPTIMIZATION.refinement_steps)
        self.point_losses = bool(L.three3d_loss or L.get("knn_points")
                                 or L.get("chamfer_distance"))
        self.knn_impl = str(L.get("knn_impl", "brute"))
        # Warm starts thread the brute KNN's indices (refine.py:1167-1174);
        # the other associations have none to thread.
        self.warm = (self.refinement_steps > 1 and self.point_losses
                     and self.knn_impl == "brute" and bool(L.get("knn_warm_start", True)))
        seed = config.SETTINGS.get("seed")
        self.generator = torch.Generator(device=device).manual_seed(
            1 if seed is None else int(seed))
        # The device learning-rate schedule while the whole-sequence program
        # runs on a card (None: the host scheduler steps).
        self._schedule: Optional[DeviceSchedule] = None
        # ``torch.cuda.set_sync_debug_mode`` around each replay of the
        # program and its input copies ("warn" or "error": a check that the
        # warm events never synchronise the host); None leaves it alone.
        self.replay_sync_mode: Optional[str] = None
        # The depth regularizer's reference: the step-0 post-scaling depth
        # of the current keyframe (refine.py:918-925; the reference
        # snapshots pre-scaling depth, the JAX package compares like with
        # like).
        self.initial_depths: Optional[Tensor] = None

    # ------------------------------------------------------------------
    # building blocks
    # ------------------------------------------------------------------
    def forward_depths(self, colors: Tensor, taps=None) -> Tuple[Tensor, Tensor]:
        """Batched depth forward of all frames. Returns (disp, depth).
        ``taps``: the decoder's zero taps (``models/decoders.py``)."""
        return self.depths_from_net(self.model(self.net_input(colors), taps=taps),
                                    colors.shape[0])

    def net_input(self, colors: Tensor) -> Tensor:
        """The network's batch for the frames ``colors`` ``[F, H, W, 3]``:
        with ``ABLATION.dual_disparity`` the frames and their horizontal
        flips, one doubled batch (reference train_depth.py:224-237)."""
        if self.config.ABLATION.get("dual_disparity", False):
            return torch.cat([colors, colors.flip(2)], dim=0)
        return colors

    def depths_from_net(self, out: Tensor, F: int) -> Tuple[Tensor, Tensor]:
        """(disp, depth) of ``F`` frames from the network's output on
        ``net_input``'s batch; the dual disparities are blended
        (train_depth.py:333-338)."""
        cfg = self.config
        # The network's disparity leaves in its compute dtype; the losses and
        # geometry run in float32 (e2eslam_tpu/engine/refine.py:237, :245).
        out = out.float()
        disp = (_merge_dual_disparity(out[:F], out[F:].flip(2))
                if cfg.ABLATION.get("dual_disparity", False) else out)
        if cfg.MODEL.depth_network == "indoor":
            return disp, indoor_disp_to_depth(disp)
        return disp, disp_to_depth(disp, float(cfg.DATA.min_depth), float(cfg.DATA.max_depth))

    def apply_scaling(self, depth: Tensor, gt_depths: Tensor,
                      intrinsics: Optional[Tensor] = None,
                      scale_params: Optional[Dict[str, Tensor]] = None) -> Tensor:
        """Focal rescaling, then the learned affine scale when
        ``scale_params`` is given (and nothing more), else online median or
        constant scaling (refine.py:254-284)."""
        abl = self.config.ABLATION
        if abl.get("scale_intrinsics", False) and intrinsics is not None:
            # CNN-SLAM-style focal rescaling (reference train_depth.py:317-325).
            depth = scale_by_focal(depth, intrinsics[0, 0], float(abl.focal_pretrain))
        if scale_params is not None:
            depth = depth * scale_params["scale"]
            if "bias" in scale_params:
                depth = depth + scale_params["bias"]
            return depth
        if not abl.get("scaled_depth", False):
            return depth
        if abl.get("scaled_depth_mode", "online") == "online":
            # reference online_adaption.py:295-298
            ms = int(abl.get("median_stride", 1) or 1)
            return depth * (_median(gt_depths[:, ::ms, ::ms]) / _median(depth[:, ::ms, ::ms]))
        depth = depth * float(abl.scaling_depth)
        if abl.get("with_bias", False):
            depth = depth + float(abl.get("scaling_bias", 0.0))
        return depth

    def _source_transform(self, pair: PairBatch, depth: Tensor, src: int) -> Tensor:
        """The target-camera -> source-camera transform
        (``e2eslam_tpu/engine/refine.py:286-314``): from the dataset's
        poses, or with ``DATA.use_gt_pose: false`` estimated by ICP between
        the predicted depths (gradICP with ``MODEL.odom: gradicp``,
        Gauss-Newton otherwise; the reference feeds SLAM-estimated poses
        back into view synthesis, ``train_depth.py:373-385``). The ICP runs
        inside the step, so the loss's gradient flows through every
        iteration into both depths."""
        if self.config.DATA.get("use_gt_pose", True):
            return se3_inverse(pair.poses[src]) @ pair.poses[TARGET]
        K = pair.intrinsics
        inv_K = inverse_intrinsics(K)[None]
        tgt_cam = backproject(depth[TARGET][None], inv_K)[0]
        src_cam = backproject(depth[src][None], inv_K)[0]
        s = int(self.slam.icp_downsample)
        tgt = tgt_cam[::s, ::s]
        return point_to_plane_icp(
            tgt.reshape(-1, 3), depth.new_ones(tgt.shape[0] * tgt.shape[1]), src_cam,
            normal_map(src_cam, edge="zero"), depth.new_ones(src_cam.shape[:2]), K,
            numiters=int(self.slam.numiters), dist_th=float(self.slam.icp_dist_th),
            soft=self.config.MODEL.odom == "gradicp")

    def view_synthesis(self, pair: PairBatch, depth: Tensor) -> Dict:
        """Warp each source frame into the target view (``_source_transform``'s
        poses); with ``LOSS.geometric`` also the warped and the resampled
        source depth."""
        cfg = self.config
        K = pair.intrinsics
        if cfg.MODEL.depth_network == "monodepth2" and cfg.DATA.get("normalize_intrinsics", False):
            K = normalize_intrinsics(K)
        K = K[None]
        cam_points = backproject(depth[TARGET][None], inverse_intrinsics(K))
        pad = cfg.MODEL.padding_mode
        outputs = {}
        for src in range(pair.colors.shape[0]):
            if src == TARGET:
                continue
            T = self._source_transform(pair, depth, src)[None]
            if cfg.LOSS.geometric:
                grid, warped, valid = project(cam_points, K, T, return_depth=True)
                outputs[("warped_depth", src)] = warped
                outputs[("interpolated_depth", src)] = grid_sample(
                    depth[src][None], grid, padding_mode=pad, align_corners=False)
                # Reference quirk kept (refine.py:342-351): with the
                # geometric loss on, colour is sampled with align_corners=True.
                synth = grid_sample(pair.colors[src][None], grid, padding_mode=pad,
                                    align_corners=True)
            else:
                grid, valid = project(cam_points, K, T)
                synth = grid_sample(pair.colors[src][None], grid, padding_mode=pad,
                                    align_corners=False)
            outputs[("synthesized_frame", src)] = synth
            outputs[("valid_mask", src)] = valid
        return outputs

    def _photometric(self, pair: PairBatch, outputs: Dict) -> Tensor:
        """Masked SSIM+L1, optionally auto-masked against the identity
        warps and reduced by the minimum over sources (refine.py:392-429)."""
        L = self.config.LOSS
        target = pair.colors[TARGET][None]
        sources = [i for i in range(pair.colors.shape[0]) if i != TARGET]

        def loss_map(image, src):
            if L.photometric_mask:
                mask = outputs[("valid_mask", src)]
                return photometric_loss(image * mask, target * mask)
            return photometric_loss(image, target)

        photometric = torch.cat([loss_map(outputs[("synthesized_frame", s)], s)
                                 for s in sources], dim=-1)
        if not L.min_reprojection:
            photometric = photometric.mean(dim=-1, keepdim=True)
        if L.auto_masking:
            identity = torch.cat([loss_map(pair.colors[s][None], s) for s in sources], dim=-1)
            if L.min_reprojection:
                identity = identity + 1e-5 * torch.randn(
                    identity.shape, generator=self.generator, dtype=identity.dtype,
                    device=identity.device)
            else:
                identity = identity.mean(dim=-1, keepdim=True)
            photometric = torch.cat([identity, photometric], dim=-1)
        if photometric.shape[-1] == 1:
            return photometric.mean()
        return photometric.amin(dim=-1).mean()

    def assemble_losses(self, pair: PairBatch, disp: Tensor, depth: Tensor, outputs: Dict,
                        map_state: Optional[MapState], initial_depths: Tensor,
                        map_index=None, knn_init=None, thread_knn: bool = False):
        """The loss family of ``RefinementEngine._assemble_losses``
        (refine.py:362-861). Returns (loss, aux); with a 3D loss on,
        ``aux["_knn_idx"]`` holds this step's NN indices (keys ``three3d``,
        ``ab``, ``ba``; ``qperm`` when ``thread_knn``) for the next step."""
        L = self.config.LOSS
        F = pair.colors.shape[0]
        sources = [i for i in range(F) if i != TARGET]
        aux: Dict = {}
        loss = aux["photometric"] = self._photometric(pair, outputs)

        if L.geometric:
            geo = torch.stack([geometric_consistency_loss(
                outputs[("warped_depth", s)], outputs[("interpolated_depth", s)],
                outputs[("valid_mask", s)]) for s in sources]).mean()
            loss = loss + geo * float(L.geometric_weight)
            aux["geometric"] = geo
        if L.smoothness:
            # Reference quirk kept (refine.py:448-455): the disparity of frame
            # 0 (a source), against the TARGET frame's edges.
            d0 = disp[0][None]
            smooth = disparity_smoothness_loss(
                d0 / (d0.mean(dim=(1, 2), keepdim=True) + 1e-7), pair.colors[TARGET][None])
            loss = loss + smooth * float(L.smoothness_weight)
            aux["smoothness"] = smooth
        if L.depth_regularizer:
            reg = depth_regularizer(initial_depths, depth, str(L.depth_regularizer_type))
            loss = loss + reg * float(L.depth_regularizer_weight)
            aux["depth_reg"] = reg
        if L.supervise_depth:
            gt_loss = 0.0
            for f in range(F):  # one generator draw per frame
                sparse_gt, mask = sparse_sampling(self.generator, pair.gt_depths[f],
                                                  float(L.sampling_prob), str(L.sampling_type))
                gt_loss = gt_loss + depth_gt_loss(depth[f], sparse_gt, mask)
            loss = loss + gt_loss * float(L.gt_depth_weight)
            aux["gt_depth"] = gt_loss
        if self.point_losses and map_state is not None:
            terms, cache = self._point_losses(pair, depth, map_state, map_index, knn_init,
                                              thread_knn)
            for name, (value, weight) in terms.items():
                loss = loss + value * weight
                aux[name] = value
            aux["_knn_idx"] = cache
        return loss, aux

    def _point_losses(self, pair, depth, map_state, map_index, knn_init, thread_knn):
        """The end-to-end 3D point losses (refine.py:479-859): three3d (or
        ``knn_points``) frame->map, and the bidirectional chamfer, by the
        exact brute-force KNN; with ``knn_impl: index`` or ``projective``
        both by projection (``_projective_terms``); with ``voxel`` three3d
        through the voxel hash and the chamfer by the brute KNN. Returns
        ({name: (value, weight)}, cache)."""
        L = self.config.LOSS
        frame = build_frame(pair.colors[TARGET], depth[TARGET], pair.intrinsics,
                            pair.poses[TARGET])
        live = frame_pointcloud(frame)
        stride = int(L.get("three3d_query_stride", 1))
        pts = live.points[::stride]
        msk = live.mask[::stride]
        debias = bool(L.get("three3d_debias", False))
        tgk = L.get("three3d_texture_gate")
        tex = texture_gate(pair.colors[TARGET], float(tgk))[::stride].detach() if tgk else None
        if str(L.get("three3d_align", "relative")) == "relative":
            # The reference's quirk: the world-frame cloud is moved by the
            # target->source transform before meeting the world-frame map.
            T_rel = se3_inverse(pair.poses[0]) @ pair.poses[TARGET]
        else:
            T_rel = torch.eye(4, dtype=pair.poses.dtype, device=pair.poses.device)
        pts = transform_points(T_rel, pts)
        # LOSS.three3d_map_stride: a strided view of the prefix-packed map
        # holds ceil(count / stride) valid rows.
        mstride = int(L.get("three3d_map_stride", 1) or 1)
        sorted_map = isinstance(map_index, SortedMap)
        map_pts = (map_index.points if sorted_map else map_state.points)[::mstride].detach()
        count = map_state.count  # an int, or a device tensor (never read here)
        map_count = -(-count // mstride)
        q_sg = pts.detach()
        knn_init = knn_init or {}
        cache: Dict[str, Tensor] = {}
        terms = {}

        def seed_ab(key):
            ki = knn_init.get(key)
            if (ki is None and sorted_map and mstride == 1
                    and bool(L.get("knn_seed_tail", True))):
                ki = self._tail_seed(q_sg, map_state, map_index)
            return ki

        def qperm():
            if not thread_knn:
                return None
            if "qperm" not in cache:
                qp = knn_init.get("qperm")
                if qp is None:
                    valid = torch.ones(q_sg.shape[0], dtype=torch.bool, device=q_sg.device)
                    qp = torch.argsort(morton_codes(q_sg, valid), stable=True)
                cache["qperm"] = qp
            return cache["qperm"]

        # Empty-map gate: the reference skips the 3D losses on the first
        # keyframe; the KNN then returns index 0 (finite) and the gate
        # zeroes the loss.
        gate = empty_map_gate(count, pts.dtype)
        if self.knn_impl in ("index", "projective"):
            return self._projective_terms(frame, live, pts, msk, tex, debias, T_rel, map_state,
                                          map_pts, map_count, gate, stride), cache
        idx_ab = None
        if L.three3d_loss or L.get("knn_points"):
            if self.knn_impl == "voxel" and map_index is not None:
                # refine.py:689-700: the voxel hash's approximate neighbours;
                # queries with no candidate in range drop out.
                _, idx, found = voxel_knn(q_sg, map_index,
                                          max_per_voxel=int(L.get("voxel_max_per", 16)))
                nn = map_state.points.detach().index_select(0, idx)
                knn_l = gate * masked_point_loss(pts, nn, msk * found.to(msk.dtype), scale=tex,
                                                 debias=debias)
            else:
                _, idx_ab = knn_points_loss(map_pts, pts, n_gt=map_count,
                                            init_idx=seed_ab("three3d"), q_perm=qperm())
                cache["three3d"] = idx_ab
                knn_l = gate * masked_point_loss(pts, map_pts[idx_ab], msk, scale=tex,
                                                 debias=debias)
            w = L.three3d_loss_weight if L.three3d_loss else L.knn_points_weight
            terms["three3d"] = (knn_l, float(w))
        if L.get("chamfer_distance"):
            # The chamfer keeps reference semantics: no texture gate, no
            # debias. a->b reuses the three3d search when it ran (the same
            # clouds).
            if idx_ab is None:
                idx_ab = knn(q_sg, map_pts, map_count, init_idx=seed_ab("ab"),
                             q_perm=qperm())[1]
            cache["ab"] = idx_ab
            d_ab = masked_point_loss(pts, map_pts[idx_ab], msk)
            # b->a: the map's valid rows query the frame, whose invalid
            # pixels sit at the sentinel.
            pts_safe = torch.where(msk[:, None] > 0, pts, torch.full_like(pts, INVALID_SENTINEL))
            ki_ba = knn_init.get("ba")
            if ki_ba is None and stride == 1:
                # Projective seeds: each map row's candidate is the pixel it
                # projects to; the refs are T_rel-shifted, so the camera is
                # T_rel o frame.pose (refine.py:822-844).
                H, W = frame.depth.shape[:2]
                ki_ba, _ = _project_pixels(map_pts, T_rel @ frame.pose, frame.intrinsics, H, W)
            idx_ba = knn(map_pts, pts_safe.detach(), nq=map_count, init_idx=ki_ba)[1]
            cache["ba"] = idx_ba
            mvalid = (torch.arange(map_pts.shape[0], device=map_pts.device)
                      < map_count).to(pts.dtype)
            # index_select: its backward is one index_add over the frame's
            # rows; advanced indexing's backward sorts the map-sized index
            # array (about 160 ms a step on an H100 at 2.6M map rows).
            d_ba = masked_point_loss(map_pts, pts_safe.index_select(0, idx_ba.long()), mvalid)
            terms["chamfer"] = (gate * (d_ab + d_ba), 0.5 * float(L.chamfer_weight))
        return terms, cache

    def _projective_terms(self, frame, live, pts, msk, tex, debias, T_rel,
                          map_state: MapState, map_pts: Tensor, map_count, gate,
                          stride: int) -> Dict:
        """The 3D losses' projective branches (refine.py:622-688, :726-783):
        each query pixel's neighbour is the map slot ``index_nn`` reads for
        it (``knn_impl: index``; ``LOSS.index_assoc_levels`` levels) or the
        nearest map point projecting onto it (``projective``, within
        ``MODEL.active_window``'s newest rows), recomputed every step from
        the step's own depth. The index three3d optionally drops matches
        farther than ``three3d_dist_gate`` and weights each by its map
        point's confidence (``three3d_conf_weight``: min(conf, 4) / 4). The
        chamfer's a->b reuses that association; its b->a pairs each valid
        map row (the first ``map_count`` of ``map_pts``; all rows, weighted
        by validity, for a device count) with the predicted point at the
        pixel it projects to in the target camera: gathers only, no KNN."""
        L = self.config.LOSS
        index = self.knn_impl == "index"
        if index:
            levels = L.get("index_assoc_levels")
            nn_idx, found = index_nn(map_state, frame, levels=int(levels) if levels else None)
        else:
            nn_idx, found = projective_nn(map_state, frame, active_window=self.active_window)
        rows = map_state.data.index_select(0, nn_idx[::stride]).detach()
        nn = rows[:, 0:3]
        w_found = msk * found[::stride].to(msk.dtype)
        terms = {}
        if L.three3d_loss or L.get("knn_points"):
            w3 = w_found
            dist_gate = L.get("three3d_dist_gate")
            if index and dist_gate:
                w3 = w3 * (((pts - nn) ** 2).sum(dim=-1) < float(dist_gate) ** 2).to(w3.dtype)
            if index and L.get("three3d_conf_weight", False):
                w3 = w3 * rows[:, 9].clamp(max=4.0) * 0.25
            w = L.three3d_loss_weight if L.three3d_loss else L.knn_points_weight
            terms["three3d"] = (gate * masked_point_loss(pts, nn, w3, scale=tex, debias=debias),
                                float(w))
        if L.get("chamfer_distance"):
            d_ab = masked_point_loss(pts, nn, w_found)
            H, W = frame.depth.shape[:2]
            if not is_device_count(map_count):
                map_pts = map_pts[:map_count]
            q_pix, in_frame = _project_pixels(map_pts, frame.pose, frame.intrinsics, H, W)
            q_pt = transform_points(T_rel, live.points).index_select(0, q_pix)
            w_ba = in_frame.to(pts.dtype) * live.mask.index_select(0, q_pix)
            if is_device_count(map_count):
                w_ba = w_ba * (torch.arange(map_pts.shape[0], device=map_pts.device)
                               < map_count).to(pts.dtype)
            d_ba = masked_point_loss(map_pts, q_pt, w_ba)
            terms["chamfer"] = (gate * (d_ab + d_ba), 0.5 * float(L.chamfer_weight))
        return terms

    def _tail_seed(self, q: Tensor, map_state: MapState, map_index: SortedMap) -> Tensor:
        """Step-0 warm-start candidates from the map's newest rows: a KNN
        against a strided view of the last 2^18 appended rows, translated
        into sorted-view positions (refine.py:544-578). A device count
        gathers the rows ``start + ts * i``; a host one slices them."""
        raw = map_state.points.detach()
        N = raw.shape[0]
        count = map_state.count
        Wt = min(N, 1 << 18)
        ts = int(self.config.LOSS.get("knn_seed_stride", 4) or 1)
        if is_device_count(count):
            start = (count - Wt).clamp(min=0, max=N - Wt)
            rows = start + torch.arange(-(-Wt // ts), device=raw.device) * ts
            n_tail = (count.clamp(max=Wt) + ts - 1) // ts
            _, tidx = knn(q, raw.index_select(0, rows), n_tail)
        else:
            start = min(max(count - Wt, 0), N - Wt)
            n_tail = (min(count, Wt) + ts - 1) // ts
            _, tidx = knn(q, raw[start:start + Wt:ts], n_tail)
        cand = (start + tidx.long() * ts).clamp(0, N - 1)
        return map_index.inv_perm[cand]

    # ------------------------------------------------------------------
    # the PFT step, fusion, the keyframe
    # ------------------------------------------------------------------
    def refine_step(self, pair: PairBatch, map_state: Optional[MapState],
                    map_index=None, knn_init=None, thread_knn: bool = False, step: int = 0):
        """One PFT step: loss, backward, Adam and the schedule. ``step`` is
        the step's index within its keyframe (step 0 snapshots the depth
        regularizer's reference).

        Returns (metrics, knn cache). Metrics are device tensors of the
        depth seen by this step's loss (before the update); with
        ``VIZ.log_gradients`` or ``VIZ.tensorboard`` they hold
        ``grad_norms``, with ``DEBUG.plot`` ``debug_images``."""
        metrics, knn_cache, _ = self._pft_step(pair, map_state, map_index, knn_init,
                                               thread_knn, step, return_grads=False)
        return metrics, knn_cache

    def refine_step_with_grads(self, pair: PairBatch, map_state: Optional[MapState],
                               map_index=None, knn_init=None, thread_knn: bool = False,
                               step: int = 0):
        """The PFT step for observability (refine.py:1590): also returns the
        gradients ``{parameter name: tensor}`` (zeros for the frozen batch
        norm and the unused disparity heads, as the JAX package's masked
        gradient tree has them) and, with ``VIZ.grad_images`` or
        ``VIZ.tensorboard`` (not with ``ABLATION.dual_disparity``), the
        decoder's activation gradients as ``metrics["grad_images"]``
        (NCHW float32, ``models/decoders.py::decoder_tap_shapes``).
        Returns (metrics, knn cache, gradients)."""
        return self._pft_step(pair, map_state, map_index, knn_init, thread_knn, step,
                              return_grads=True)

    def _pft_step(self, pair, map_state, map_index, knn_init, thread_knn, step, *,
                  return_grads: bool):
        cfg = self.config
        obs_grads = bool(cfg.VIZ.get("log_gradients") or cfg.VIZ.get("tensorboard"))
        obs_images = bool(cfg.DEBUG.get("plot"))
        taps = None
        if (return_grads and bool(cfg.VIZ.get("grad_images") or cfg.VIZ.get("tensorboard"))
                and not cfg.ABLATION.get("dual_disparity", False)):
            F, H, W = pair.colors.shape[:3]
            # In the network's compute dtype, as its activations.
            taps = {k: torch.zeros(shape, dtype=self.model.encoder.dtype,
                                   device=pair.colors.device,
                                   requires_grad=True)
                    for k, shape in decoder_tap_shapes(F, H, W).items()}
        with tracing.phase("step.encoder"):
            # The program's replays keep the gradients' buffers: zeroed, not freed.
            self.optimizer.zero_grad(set_to_none=self._schedule is None)
            features = self.model.encode(self.net_input(pair.colors))
        with tracing.phase("step.decoder"):
            out = self.model.decode(features, taps=taps)
            disp, depth = self.depths_from_net(out, pair.colors.shape[0])
        with tracing.phase("step.loss"):
            loss, aux, depth, outputs = self.step_loss(pair, disp, depth, map_state, map_index,
                                                       knn_init, thread_knn, step)
        with tracing.phase("step.loss_grad"), tracing.grad_phases(
                (out, "step.decoder_grad"), (features[-1], "step.encoder_grad")):
            loss.backward()
            for p in self._zero_grads:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = None
            if obs_grads or return_grads:
                # Every parameter, a zero standing in for a missing gradient
                # (refine.py:974-977, :999-1005).
                grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                         for n, p in self.model.named_parameters()}
        with tracing.phase("step.optimizer"):
            if self._schedule is None:
                self.optimizer.step()
                self.scheduler.step()
            else:
                self._schedule.set_lr()
                self.optimizer.step()
                self._schedule.stepped()
        with tracing.phase("step.metrics"):
            knn_cache = aux.pop("_knn_idx", None)
            metrics = self.step_metrics(pair, depth, loss, aux)
            if obs_images:
                metrics["debug_images"] = self._debug_images(pair, depth, outputs)
            if obs_grads:
                norms = torch._foreach_norm([g.float() for g in grads.values()])
                metrics["grad_norms"] = dict(zip(grads, norms))
            if taps is not None:
                metrics["grad_images"] = {k: t.grad.float() for k, t in taps.items()}
        return metrics, knn_cache, grads if return_grads else None

    def step_loss(self, pair: PairBatch, disp: Tensor, depth: Tensor,
                  map_state: Optional[MapState], map_index=None, knn_init=None,
                  thread_knn: bool = False, step: int = 0):
        """The PFT step's loss from the network's (disp, unscaled depth) of
        the window ``pair``: scaling, the depth regularizer's reference (the
        step-0 depth), view synthesis and the loss family. Returns (loss,
        aux, scaled depth, view-synthesis outputs)."""
        depth = self.apply_scaling(depth, pair.gt_depths, pair.intrinsics)
        if step == 0:
            self.initial_depths = depth.detach()
        elif self.initial_depths is None:
            self.initial_depths = torch.zeros_like(depth)  # the JAX state's zeros
        outputs = self.view_synthesis(pair, depth)
        loss, aux = self.assemble_losses(pair, disp, depth, outputs, map_state,
                                         self.initial_depths, map_index, knn_init, thread_knn)
        return loss, aux, depth, outputs

    def _debug_images(self, pair: PairBatch, depth: Tensor, outputs: Dict) -> Dict[str, Tensor]:
        """``DEBUG.plot``'s images (refine.py:942-960, reference
        train_depth.py:551-612): the first source's synthesized target view,
        its per-pixel photometric error, the target depth and, with
        ``LOSS.three3d_texture_gate``, the gate."""
        src = next(i for i in range(pair.colors.shape[0]) if i != TARGET)
        with torch.no_grad():
            synth = outputs[("synthesized_frame", src)][0]
            images = {"synthesized_frame": synth.detach(),
                      "photometric_error": (synth - pair.colors[TARGET]).abs().mean(dim=-1),
                      "depth": depth[TARGET, ..., 0].detach()}
            tgk = self.config.LOSS.get("three3d_texture_gate")
            if tgk:
                H, W = pair.colors.shape[1:3]
                images["texture_gate"] = texture_gate(pair.colors[TARGET],
                                                      float(tgk)).reshape(H, W)
        return images

    # ------------------------------------------------------------------
    # the offline modes: OFT, SCALE, the inference forward
    # ------------------------------------------------------------------
    @torch.no_grad()
    def predict_depth(self, colors: Tensor) -> Tuple[Tensor, Tensor]:
        """Inference forward of all frames (refine.py:1647). Returns
        (disp, depth), unscaled."""
        return self.forward_depths(colors)

    def oft_state(self, depths: Tensor) -> OFTState:
        """The depth maps as OFT's variable, with a fresh optimizer and
        schedule from the config: its update count starts at 0."""
        d = depths.detach().clone().requires_grad_(True)
        optimizer, scheduler = make_optimizer(self.config, [d])
        return OFTState(d, optimizer, scheduler)

    def oft_step(self, oft: OFTState, initial_depths: Tensor, pair: PairBatch,
                 map_state: Optional[MapState], map_index=None) -> Dict:
        """One output fine-tuning step (refine.py:1410-1449): the loss of the
        scaled depth maps, ``disp = 1 / max(depth, 1e-6)``, its gradient with
        respect to the maps, one optimizer update of ``oft.depths`` in place.
        ``initial_depths`` is the post-scaling frozen depth (the depth
        regularizer's reference). No warm starts are threaded: the brute
        searches seed from the map's tail at every step. Returns the
        metrics of the depth the loss saw."""
        oft.optimizer.zero_grad(set_to_none=True)
        depth = self.apply_scaling(oft.depths, pair.gt_depths, pair.intrinsics)
        disp = 1.0 / depth.clamp(min=1e-6)
        outputs = self.view_synthesis(pair, depth)
        loss, aux = self.assemble_losses(pair, disp, depth, outputs, map_state,
                                         initial_depths, map_index)
        loss.backward()
        oft.optimizer.step()
        oft.scheduler.step()
        aux.pop("_knn_idx", None)
        return self.step_metrics(pair, depth, loss, aux)

    def oft_window(self, pair: PairBatch, map_state: Optional[MapState]):
        """A window of output fine-tuning (refine.py:1451-1486): one frozen
        forward, the post-scaling reference depth, a fresh optimizer, the
        map's index, then ``OPTIMIZATION.refinement_steps`` OFT steps.
        Returns (optimized depths, the last step's metrics)."""
        _, depths = self.predict_depth(pair.colors)
        initial = self.apply_scaling(depths, pair.gt_depths, pair.intrinsics).detach()
        oft = self.oft_state(depths)
        map_index = self.build_map_index(map_state) if map_state is not None else None
        metrics = None
        for _ in range(self.refinement_steps):
            metrics = self.oft_step(oft, initial, pair, map_state, map_index)
        return oft.depths.detach(), metrics

    def scale_state(self, init_value: float, use_bias: bool) -> ScaleState:
        """The learned scale ``init_value`` (and a bias of 0) with a fresh
        optimizer and schedule from the config."""
        dev = self.device
        params = {"scale": torch.tensor(float(init_value), device=dev, requires_grad=True)}
        if use_bias:
            params["bias"] = torch.tensor(0.0, device=dev, requires_grad=True)
        optimizer, scheduler = make_optimizer(self.config, list(params.values()))
        return ScaleState(params, optimizer, scheduler)

    def scale_step(self, sc: ScaleState, pair: PairBatch, map_state: Optional[MapState],
                   frozen: Tuple[Tensor, Tensor]) -> Dict:
        """One SCALE step (refine.py:1488-1537): the frozen network's depth
        times the learned scale (plus its bias), the loss, its gradient with
        respect to ``sc.params`` alone, one update. ``frozen``: the window's
        ``predict_depth`` (disp, depth), which no step changes (the JAX step
        recomputes it each time). Returns the metrics."""
        if self.config.LOSS.get("depth_regularizer"):
            raise ValueError("LOSS.depth_regularizer has no effect in SCALE mode "
                             "(no initial-depth snapshot exists); disable it")
        disp, raw = frozen
        sc.optimizer.zero_grad(set_to_none=True)
        depth = self.apply_scaling(raw, pair.gt_depths, pair.intrinsics, scale_params=sc.params)
        outputs = self.view_synthesis(pair, depth)
        loss, aux = self.assemble_losses(pair, disp, depth, outputs, map_state, depth)
        loss.backward()
        sc.optimizer.step()
        sc.scheduler.step()
        aux.pop("_knn_idx", None)
        return self.step_metrics(pair, depth, loss, aux)

    def step_metrics(self, pair: PairBatch, depth: Tensor, loss: Tensor, aux: Dict) -> Dict:
        """The depth metrics of the window's target frame, the loss and its
        terms, detached."""
        with torch.no_grad():
            metrics = depth_metrics(self.config.DATA.name, pair.gt_depths[TARGET],
                                    depth[TARGET].detach())
        metrics["total_loss"] = loss.detach()
        metrics.update({k: v.detach() for k, v in aux.items()})
        return metrics

    @torch.no_grad()
    def fuse_pair(self, pair: PairBatch, map_state: MapState, *, fuse_prev: bool):
        """Fuse a refined pair (prev, live) into the map (reference
        ``create_refined_pointcloud``, online_adaption.py:329-366). Returns
        (map, estimated live pose)."""
        _, depth = self.forward_depths(pair.colors)
        return self.fuse_depth(pair, depth, map_state, fuse_prev=fuse_prev)

    @torch.no_grad()
    def fuse_depth(self, pair: PairBatch, depth: Tensor, map_state: MapState, *,
                   fuse_prev: bool, active: Optional[Tensor] = None):
        """``fuse_pair`` from the network's unscaled depth of ``pair``;
        where ``active`` (a 0-d bool tensor) is False the map is left as it
        was."""
        depth = self.apply_scaling(depth, pair.gt_depths, pair.intrinsics)
        prev = build_frame(pair.colors[0], depth[0], pair.intrinsics, pair.poses[0])
        if fuse_prev:
            map_state = self.slam._update_map(map_state, prev, active)
        live = build_frame(pair.colors[TARGET], depth[TARGET], pair.intrinsics,
                           pair.poses[TARGET])
        map_state, est_pose, _ = self.slam.step(map_state, live, prev, active)
        return map_state, est_pose

    def make_empty_map(self) -> MapState:
        """The empty global map for this config: the one place that decides
        whether the map keeps index images (index fusion or index
        association; refine.py:1028-1046)."""
        cfg = self.config
        needs_index = (str(cfg.MODEL.get("fusion_impl", "scatter")) == "index"
                       or self.knn_impl == "index")
        H, W = int(cfg.DATA.height), int(cfg.DATA.width)
        return empty_map(self.map_capacity, device=self.device,
                         index_hw=H * W if needs_index else None,
                         index_levels=int(cfg.MODEL.get("index_levels", 1) or 1))

    def build_map_index(self, map_state: MapState, bucket: Optional[int] = None):
        """The 3D loss's index over the map (refine.py:1048-1080): the voxel
        hash for ``knn_impl: voxel``; for the brute KNN with a 3D loss on,
        a Morton-sorted view of the map's first ``bucket`` rows (all valid
        rows live there) unless the sort is off; else None."""
        L = self.config.LOSS
        if self.knn_impl == "voxel":
            return build_voxel_index(map_state.points.detach(), map_state.count,
                                     float(L.get("voxel_size", 0.1)),
                                     table_size=1 << int(L.get("voxel_table_pow", 20)))
        if not (self.point_losses and self.knn_impl == "brute"
                and bool(L.get("knn_spatial_sort", True))):
            return None
        pts = map_state.points.detach()
        if bucket is not None:
            pts = pts[:bucket]
        return sort_map_points(pts, map_state.count)

    def compact_now(self, map_state: MapState, pose: Tensor, K: Tensor,
                    bucket: Optional[int] = None) -> MapState:
        """One configured compaction pass (refine.py:1101-1153):
        ``MODEL.compact_mode`` projective (from the camera at ``pose``, gated
        at ``dist_th`` and ``angle_th``) or voxel (``compact_live_voxel``).
        With ``bucket`` (an upper bound on the count) the pass runs over
        ``data[:bucket]``, which holds every valid row, and the result is
        written back into the full buffer."""
        M = self.config.MODEL
        full = None
        if bucket is not None and int(bucket) < map_state.data.shape[0]:
            full = map_state.data
            map_state = dataclasses.replace(map_state, data=map_state.data[: int(bucket)])
        if str(M.get("compact_mode", "voxel") or "voxel") == "projective":
            H, W = int(self.config.DATA.height), int(self.config.DATA.width)
            out = compact_map_projective(
                map_state, pose, K, height=H, width=W,
                dist_gate=float(M.get("dist_th", 0.05) or 0.05),
                normal_gate_deg=float(M.get("angle_th", 20.0) or 20.0))
        else:
            out = compact_map(map_state, voxel=float(M.get("compact_live_voxel", 0.01) or 0.01))
        if full is not None:
            full[: out.data.shape[0]] = out.data
            out = dataclasses.replace(out, data=full)
        return out

    @staticmethod
    def map_view(map_state: MapState, map_index=None) -> MapState:
        """The map the keyframe's steps and fusion run on: with a bucketed
        sorted view (``map_index`` shorter than the buffer) the buffer's
        first rows, which hold every valid row; else the map itself."""
        if isinstance(map_index, SortedMap) and map_index.points.shape[0] < map_state.data.shape[0]:
            return dataclasses.replace(map_state, data=map_state.data[: map_index.points.shape[0]])
        return map_state

    def process_pair(self, pair: PairBatch, map_state: MapState, map_index=None, *,
                     fuse_prev: bool, fuse_batch: Optional[PairBatch] = None,
                     knn_init0=None) -> Tuple[MapState, List[Dict], Tensor, Optional[Dict]]:
        """A keyframe: R refinement steps on the window ``pair``, then fusion
        of ``fuse_batch`` (the newest pair (prev, frame); default ``pair``).

        With a bucketed sorted view (``map_index`` shorter than the buffer)
        the steps and the fusion run on the buffer's first rows, which hold
        every valid row. ``knn_init0`` (the previous keyframe's final KNN
        cache) seeds step 0 when the sorted view's permutation is unchanged.
        Returns (map, per-step metrics, estimated pose, final KNN cache).
        """
        view = self.map_view(map_state, map_index)
        steps = []
        kc = knn_init0 if self.warm else None
        for i in range(self.refinement_steps):
            metrics, cache = self.refine_step(pair, view, map_index, knn_init=kc,
                                              thread_knn=self.warm, step=i)
            if self.warm:
                kc = cache
            steps.append(metrics)
        with tracing.phase("event.fusion"):
            view, est_pose = self.fuse_pair(fuse_batch or pair, view, fuse_prev=fuse_prev)
        return dataclasses.replace(view, data=map_state.data), steps, est_pose, kc

    # ------------------------------------------------------------------
    # the whole-sequence program
    # ------------------------------------------------------------------
    def _sequence_event(self, seq, K: Tensor, pair_i: Tensor, ev_i: Tensor, ms: MapState,
                        carry: Dict, out: Dict, est: Tensor, *, fuse_prev: bool) -> None:
        """One event of the whole-sequence program (JAX refine.py:1361-1394):
        the pair ``pair_i`` (int64 ``[2]`` on the device: previous and
        current frame) gathered from the sequence ``seq`` (colors, depths,
        poses), a fresh Morton sort of the whole buffer, R PFT steps seeded
        by the previous event's final KNN cache, then fusion. Everything it
        keeps is written in place: the map ``ms`` (its count and index
        images), the cache ``carry["kc"]``, the last step's metrics
        (``event_rows``: with the observability outputs on, the gradient
        norms and the debug images too) into row ``ev_i`` of ``out``'s
        ``[E, ...]`` buffers (allocated on the first event) and the
        estimated pose into ``est[ev_i]``. So a CUDA graph of it replays
        against the same tensors."""
        colors, gt_depths, poses = seq
        with tracing.event(ev_i):
            with tracing.phase("event.inputs"):
                pair = PairBatch(colors=colors.index_select(0, pair_i),
                                 gt_depths=gt_depths.index_select(0, pair_i), intrinsics=K,
                                 poses=poses.index_select(0, pair_i))
            with tracing.phase("event.sort"):
                # The whole buffer's sort: the seeds it invalidates are
                # re-scored (refine.py:1375-1380).
                map_index = self.build_map_index(ms)
            new, steps, est_pose, kc = self.process_pair(pair, ms, map_index,
                                                         fuse_prev=fuse_prev,
                                                         knn_init0=carry.get("kc"))
            with tracing.phase("event.rows"):
                for name, value in event_rows(steps[-1]).items():
                    if name not in out:
                        out[name] = value.new_zeros((est.shape[0],) + value.shape)
                    out[name].index_copy_(0, ev_i, value[None])
                est.index_copy_(0, ev_i, est_pose[None].to(est.dtype))
                store_map(ms, new)
                if kc is not None:
                    if carry.get("kc") is None:
                        carry["kc"] = {k: v.clone() for k, v in kc.items()}
                    else:
                        for k, v in kc.items():
                            carry["kc"][k].copy_(v)

    def compact_in_place(self, ms: MapState, pose: Tensor, K: Tensor, bound: int) -> Tensor:
        """The programs' compaction pass: the configured pass over the
        bucket of rows that holds ``bound`` (a host-known upper bound on
        ``ms``'s device count), written back into ``ms``'s own tensors with
        nothing read to the host. The JAX program picks the smallest bucket
        that holds the count (``compact_switch``, refine.py:1317-1349); any
        larger one gives the same map, since every valid row lies in the
        prefix and the rows past the count are zeros that take no part.
        Returns the counts before and after, int64 ``[2]`` on the device."""
        bucket = (compact_bucket(bound, ms.data.shape[0])
                  if bool(self.config.MODEL.get("compact_bucket", True)) else None)
        new = self.compact_now(ms, pose, K, bucket=bucket)
        counts = torch.stack([ms.count, new.count]).to(torch.int64)
        if new.data.data_ptr() != ms.data.data_ptr():
            ms.data.copy_(new.data)
        store_map(ms, new)
        return counts

    def fused_rows_bound(self, start: int, fused_frames: int) -> int:
        """An upper bound on the count after ``fused_frames`` fusions from
        a count of ``start``: each appends at most one row a pixel
        (``slam/fusion.py``: the appends are the frame's unclaimed valid
        pixels), capped at the capacity."""
        H, W = int(self.config.DATA.height), int(self.config.DATA.width)
        return min(start + fused_frames * H * W, self.map_capacity)

    def process_sequence(self, map_state: MapState, colors: Tensor, gt_depths: Tensor,
                         K: Tensor, poses: Tensor, prev_idx, cur_idx):
        """The whole keyframe schedule as one program (the JAX engine's
        ``process_sequence``, refine.py:1277-1405 and :1611-1621): event ``e``
        refines and fuses the pair ``(prev_idx[e], cur_idx[e])`` of the
        sequence (``colors``, ``gt_depths``, ``poses`` ``[L, ...]`` on the
        engine's device); event 0 also fuses its previous frame; the
        cross-keyframe KNN cache threads through every event; with
        ``MODEL.compact_period`` P the map is compacted after event ``e``
        when ``(e + 1) % P == 0``, from that event's estimated camera.

        Nothing is read to the host before the end. Each event runs as
        ``event_schedule(E, cuda)`` says: on a CUDA device with E >= 3,
        event 0 eagerly on the process's side stream, event 1 captured as
        a CUDA graph into the process's graph pool (``capture_graph``) and
        replayed, events 2..E-1 replays (a failed capture raises; nothing
        falls back to the per-keyframe loop); on the CPU, or with E <= 2,
        every event eagerly. The graph is created, replayed and dropped
        inside this call, so no two programs' graphs of a process replay
        at once, which is what lets them share the pool. A compaction pass is
        launched between events with no read (``compact_in_place``), over
        the bucket that holds a host bound on the count. ``map_state`` is
        updated in place (its count becomes a device tensor).

        While a run is traced (``utils/tracing.py``) each event's phases
        are host ranges and device timestamps in the graph.

        Returns (map, metrics ``{name: [E, ...]}`` of each event's last
        step (``event_rows``), estimated poses ``[E, 4, 4]``, info:
        ``graphs`` captured,
        ``capture_s``, ``compactions`` ``[{"keyframe", "counts"}]``, each
        pass's counts before and after as int64 ``[2]``, and ``counts``
        (``program_counts``: the caching allocator's device allocations and
        frees during the call and its eager events, also the traced run's
        ``counts``)), all on the device but the info's numbers."""
        E = len(prev_idx)
        dev = self.device
        cuda = dev.type == "cuda"
        calls = allocator_calls(dev)
        # A device count gives no host bound but the capacity.
        start = map_state.count if isinstance(map_state.count, int) else map_state.data.shape[0]
        ms = on_device(map_state)
        out: Dict[str, Tensor] = {}
        est = torch.zeros(E, 4, 4, dtype=poses.dtype, device=dev)
        info = {"graphs": 0, "capture_s": 0.0, "compactions": [],
                "counts": program_counts(dev, calls, 0)}
        if E == 0:
            return ms, out, est, info
        pairs = torch.tensor([[int(p), int(c)] for p, c in zip(prev_idx, cur_idx)],
                             dtype=torch.int64)
        events = torch.arange(E, dtype=torch.int64)[:, None]
        if cuda:
            pairs, events = pairs.pin_memory(), events.pin_memory()
        # The graph's inputs: written from pinned memory before each event.
        pair_i = torch.zeros(2, dtype=torch.int64, device=dev)
        ev_i = torch.zeros(1, dtype=torch.int64, device=dev)
        seq = (colors, gt_depths, poses)
        carry: Dict = {}
        period = int(self.config.MODEL.get("compact_period", 0) or 0)
        if cuda:
            self._schedule = DeviceSchedule(self.config, self.optimizer, self.scheduler, dev)
        kinds = event_schedule(E, cuda)
        side = program_streams(dev)[0] if cuda else None
        if cuda:
            side.wait_stream(torch.cuda.current_stream(dev))
        tracing.begin_events(E, tracing.phase_names(self.refinement_steps,
                                                     tracing.NETWORK_STEP_PHASES), dev,
                             replayed=[k != "eager" for k in kinds])
        graph = None
        try:
            for e in range(E):
                warm = kinds[e] != "eager"
                ctx = torch.cuda.stream(side) if cuda and not warm else contextlib.nullcontext()
                with ctx:
                    if kinds[e] == "capture":
                        torch.cuda.current_stream(dev).wait_stream(side)
                        with tracing.span("program.capture"):
                            graph = self._capture_event(seq, K, pair_i, ev_i, ms, carry, out,
                                                        est, info)
                    if warm:
                        with tracing.span("program.replay"), _sync_debug(self.replay_sync_mode):
                            pair_i.copy_(pairs[e], non_blocking=True)
                            ev_i.copy_(events[e], non_blocking=True)
                            graph.replay()
                    else:
                        with tracing.span("program.eager_event"):
                            pair_i.copy_(pairs[e], non_blocking=True)
                            ev_i.copy_(events[e], non_blocking=True)
                            self._sequence_event(seq, K, pair_i, ev_i, ms, carry, out, est,
                                                 fuse_prev=e == 0)
                    if period and (e + 1) % period == 0:
                        # Event 0 fuses two frames, every later event one.
                        bound = self.fused_rows_bound(start, e + 2)
                        with tracing.span("program.compact"), \
                                _sync_debug(self.replay_sync_mode if cuda else None):
                            counts = self.compact_in_place(ms, est[e], K, bound)
                        info["compactions"].append({"keyframe": e, "counts": counts})
            if cuda and graph is None:
                torch.cuda.current_stream(dev).wait_stream(side)
        finally:
            if self._schedule is not None:
                self._schedule.exit()
                self._schedule = None
        info["counts"] = program_counts(dev, calls, kinds.count("eager"))
        tracing.count(info["counts"])
        return ms, out, est, info

    def _capture_event(self, seq, K, pair_i, ev_i, ms, carry, out, est, info):
        """Capture one warm event (no fusion of the previous frame) as a CUDA
        graph (``capture_graph``); its random draws, if any, from the
        engine's generator."""
        L = self.config.LOSS
        graph = torch.cuda.CUDAGraph()
        if L.get("supervise_depth") or (L.get("auto_masking") and L.get("min_reprojection")):
            graph.register_generator_state(self.generator)
        t0 = time.perf_counter()
        capture_graph(graph, self.device, lambda: self._sequence_event(
            seq, K, pair_i, ev_i, ms, carry, out, est, fuse_prev=False))
        info["capture_s"] += time.perf_counter() - t0
        info["graphs"] += 1
        return graph


def event_rows(metrics: Dict) -> Dict[str, Tensor]:
    """A step's metrics as the rows the programs write for an event, each
    a tensor on the device: each scalar 0-d, ``grad_norms`` stacked into
    one ``[P]`` row in the network's ``named_parameters`` order, each
    debug image (``[H, W, ...]``) under ``debug_images/<name>``. The JAX
    programs stack the whole metrics tree (refine.py:1381-1403)."""
    rows = {}
    for name, value in metrics.items():
        if name == "grad_norms":
            rows[name] = torch.stack(list(value.values()))
        elif isinstance(value, dict):
            rows.update({f"{name}/{k}": v for k, v in value.items()})
        else:
            rows[name] = value.reshape(())
    return rows


def metrics_from_rows(rows: Dict, norm_names: List[str]) -> Dict:
    """One event's metrics from its rows read to the host (``rows``: name
    -> a numpy array, as ``event_rows`` names them), in the loop's nested
    shape (``host_metrics``)."""
    m: Dict = {}
    for key, value in rows.items():
        if key == "grad_norms":
            m[key] = {n: float(v) for n, v in zip(norm_names, value)}
        elif "/" in key:
            head, name = key.split("/", 1)
            m.setdefault(head, {})[name] = value
        else:
            m[key] = float(value)
    return m


def host_metrics(metrics: Dict) -> Dict:
    """A step's metrics on the host: each scalar a float, ``grad_norms``
    ``{parameter name: float}`` (one read for all), each debug image a
    float32 numpy array."""
    out = {}
    for k, v in metrics.items():
        if k == "grad_norms":
            out[k] = dict(zip(v, torch.stack(list(v.values())).tolist()))
        elif isinstance(v, dict):
            out[k] = {n: t.detach().float().cpu().numpy() for n, t in v.items()}
        else:
            out[k] = float(v)
    return out


def event_schedule(n_events: int, cuda: bool) -> List[str]:
    """How a program runs each of its ``n_events`` keyframe events:
    ``"eager"``, ``"capture"`` (captured as the program's CUDA graph, then
    replayed) or ``"replay"``. On a card with at least three events, event
    0 runs eagerly (it sets up cuDNN, autograd and the optimizer's state,
    and the KNN cache the later events are seeded from) and event 1 is
    captured; with fewer, a capture would pay for at most one replay, so
    every event runs eagerly, as on the CPU."""
    if cuda and n_events >= 3:
        return ["eager", "capture"] + ["replay"] * (n_events - 2)
    return ["eager"] * n_events


# The process's graph pool and program streams, one of each per card. A
# program creates, replays and drops its graph inside one call, and one
# program runs at a time in a process (the caching allocator and the card
# belong to the process too), so no two graphs that share the pool ever
# replay at once.
_GRAPH_POOLS: Dict[int, Tuple[Tuple[int, int], "torch.cuda.CUDAGraph"]] = {}
_PROGRAM_STREAMS: Dict[int, Tuple["torch.cuda.Stream", "torch.cuda.Stream"]] = {}


def _card_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def program_streams(device: torch.device) -> Tuple["torch.cuda.Stream", "torch.cuda.Stream"]:
    """The process's (side, capture) streams on ``device``: the programs'
    eager events run on the first, their captures on the second. Kept for
    the process, since the caching allocator caches a block for the
    stream it was allocated on: fresh streams for every run would leave
    each run's blocks unusable by the next."""
    index = _card_index(device)
    streams = _PROGRAM_STREAMS.get(index)
    if streams is None:
        streams = _PROGRAM_STREAMS[index] = (torch.cuda.Stream(device=index),
                                             torch.cuda.Stream(device=index))
    return streams


def graph_pool(device: torch.device) -> Tuple[int, int]:
    """The handle of the process's CUDA graph pool on ``device``. One graph
    of a single fill is captured into it and kept with it: while a graph
    of the pool lives, the device's caching allocator keeps the pool's
    blocks for its next capture and the pinned host allocator keeps the
    pool's entry (a ``torch.cuda.MemPool`` holds only the device's side,
    and a capture into a pool whose host entry no graph holds fails), so
    the blocks a dropped program graph leaves are the next capture's."""
    index = _card_index(device)
    entry = _GRAPH_POOLS.get(index)
    if entry is None:
        pool, anchor = torch.cuda.graph_pool_handle(), torch.cuda.CUDAGraph()
        capture_graph(anchor, device, lambda: torch.zeros(1, device=device), pool)
        entry = _GRAPH_POOLS[index] = (pool, anchor)
    return entry[0]


def capture_graph(graph: "torch.cuda.CUDAGraph", device: torch.device, body,
                  pool=None) -> None:
    """Capture ``body()`` into ``graph`` on the process's capture stream,
    into ``pool`` (the process's graph pool by default: ``program_streams``,
    ``graph_pool``), the capture stream behind the current one. Unlike
    ``torch.cuda.graph`` it neither synchronises nor empties the device's or
    the pinned host allocator's caches: those carry over from one program
    to the next."""
    pool = graph_pool(device) if pool is None else pool
    stream = program_streams(device)[1]
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        try:
            body()
        finally:
            graph.capture_end()


def allocator_calls(device: torch.device) -> Tuple[int, int]:
    """The caching allocator's device allocations and frees (its
    ``cudaMalloc`` and ``cudaFree`` calls) on ``device`` so far; (0, 0)
    off a card."""
    if device.type != "cuda":
        return 0, 0
    stats = torch.cuda.memory_stats(device)
    return int(stats.get("num_device_alloc", 0)), int(stats.get("num_device_free", 0))


def program_counts(device: torch.device, before: Tuple[int, int],
                   eager_events: int) -> Dict[str, int]:
    """A program call's ``counts``: the caching allocator's device
    allocations and frees since ``before`` (``allocator_calls``) and the
    call's ``eager_events``."""
    allocs, frees = allocator_calls(device)
    return {"device_allocs": allocs - before[0], "device_frees": frees - before[1],
            "eager_events": eager_events}


@contextlib.contextmanager
def _sync_debug(mode: Optional[str]):
    """``torch.cuda.set_sync_debug_mode(mode)`` inside the block (None: as
    it is)."""
    if mode is None:
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def store_map(dst: MapState, src: MapState) -> None:
    """Write ``src``'s count, keyframe counter, index images and poses into
    ``dst``'s tensors in place (``src.data`` is ``dst.data``: fusion writes
    the buffer in place). The second level goes first: it may be the first
    level's old image."""
    for name in ("index_image2", "index_pose2", "index_image", "index_pose", "count",
                 "kf_counter"):
        d, s = getattr(dst, name), getattr(src, name)
        if d is not None and d is not s:
            d.copy_(s)
