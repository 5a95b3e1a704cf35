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

Eager PyTorch needs no counterpart of the JAX whole-keyframe and
whole-sequence programs; the engine is a plain per-step loop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from e2eslam_tpu_torch.core.camera import inverse_intrinsics, normalize_intrinsics
from e2eslam_tpu_torch.core.depth import disp_to_depth, indoor_disp_to_depth
from e2eslam_tpu_torch.core.projection import backproject, project
from e2eslam_tpu_torch.core.sampling import grid_sample
from e2eslam_tpu_torch.core.se3 import se3_inverse, transform_points
from e2eslam_tpu_torch.engine.optim import make_optimizer
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
from e2eslam_tpu_torch.ops.knn import knn
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
from e2eslam_tpu_torch.slam.pointclouds import MapState, empty_map
from e2eslam_tpu_torch.slam.rgbd import build_frame, normal_map
from e2eslam_tpu_torch.slam.slam import PointFusion

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


def validate_config(config) -> None:
    """Refuse settings whose code paths the port does not carry yet (the
    OFT and SCALE refinements, ``compute_dtype`` other than float32 and
    bfloat16; ROADMAP.md, queue A), a ``knn_impl``, ``fusion_impl`` or
    ``compact_mode`` the JAX package lacks too, and its inconsistent pair
    (``e2eslam_tpu/engine/refine.py:149-163``)."""
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
    if str(O.get("refinement", "PFT")) != "PFT":
        bad.append("OPTIMIZATION.refinement (only PFT)")
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
        # The depth regularizer's reference: the step-0 post-scaling depth
        # of the current keyframe (refine.py:918-925; the reference
        # snapshots pre-scaling depth, the JAX package compares like with
        # like).
        self.initial_depths: Optional[Tensor] = None

    # ------------------------------------------------------------------
    # building blocks
    # ------------------------------------------------------------------
    def forward_depths(self, colors: Tensor) -> Tuple[Tensor, Tensor]:
        """Batched depth forward of all frames. Returns (disp, depth)."""
        cfg = self.config
        # The network's disparity leaves in its compute dtype; the losses and
        # geometry run in float32 (e2eslam_tpu/engine/refine.py:237, :245).
        if cfg.ABLATION.get("dual_disparity", False):
            # The image and its horizontal flip in one doubled batch, blended
            # (reference train_depth.py:224-237, :333-338).
            F = colors.shape[0]
            d = self.model(torch.cat([colors, colors.flip(2)], dim=0)).float()
            disp = _merge_dual_disparity(d[:F], d[F:].flip(2))
        else:
            disp = self.model(colors).float()
        if cfg.MODEL.depth_network == "indoor":
            return disp, indoor_disp_to_depth(disp)
        return disp, disp_to_depth(disp, float(cfg.DATA.min_depth), float(cfg.DATA.max_depth))

    def apply_scaling(self, depth: Tensor, gt_depths: Tensor,
                      intrinsics: Optional[Tensor] = None) -> Tensor:
        """Focal rescaling, then online median or constant scaling
        (refine.py:254-284)."""
        abl = self.config.ABLATION
        if abl.get("scale_intrinsics", False) and intrinsics is not None:
            # CNN-SLAM-style focal rescaling (reference train_depth.py:317-325).
            depth = depth * (intrinsics[0, 0] / float(abl.focal_pretrain))
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
        count = map_state.count
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
        gate = 1.0 if count > 0 else 0.0
        if self.knn_impl in ("index", "projective"):
            return self._projective_terms(frame, live, pts, msk, tex, debias, T_rel, map_state,
                                          map_pts[:map_count], gate, stride), cache
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
                          map_state: MapState, map_pts: Tensor, gate: float, stride: int) -> Dict:
        """The 3D losses' projective branches (refine.py:622-688, :726-783):
        each query pixel's neighbour is the map slot ``index_nn`` reads for
        it (``knn_impl: index``; ``LOSS.index_assoc_levels`` levels) or the
        nearest map point projecting onto it (``projective``, within
        ``MODEL.active_window``'s newest rows), recomputed every step from
        the step's own depth. The index three3d optionally drops matches
        farther than ``three3d_dist_gate`` and weights each by its map
        point's confidence (``three3d_conf_weight``: min(conf, 4) / 4). The
        chamfer's a->b reuses that association; its b->a pairs each valid
        map row of ``map_pts`` with the predicted point at the pixel it
        projects to in the target camera: gathers only, no KNN."""
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
            q_pix, in_frame = _project_pixels(map_pts, frame.pose, frame.intrinsics, H, W)
            q_pt = transform_points(T_rel, live.points).index_select(0, q_pix)
            w_ba = in_frame.to(pts.dtype) * live.mask.index_select(0, q_pix)
            d_ba = masked_point_loss(map_pts, q_pt, w_ba)
            terms["chamfer"] = (gate * (d_ab + d_ba), 0.5 * float(L.chamfer_weight))
        return terms

    def _tail_seed(self, q: Tensor, map_state: MapState, map_index: SortedMap) -> Tensor:
        """Step-0 warm-start candidates from the map's newest rows: a KNN
        against a strided view of the last 2^18 appended rows, translated
        into sorted-view positions (refine.py:544-578)."""
        raw = map_state.points.detach()
        N = raw.shape[0]
        count = map_state.count
        Wt = min(N, 1 << 18)
        start = min(max(count - Wt, 0), N - Wt)
        ts = int(self.config.LOSS.get("knn_seed_stride", 4) or 1)
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
        depth seen by this step's loss (before the update)."""
        self.optimizer.zero_grad(set_to_none=True)
        disp, depth = self.forward_depths(pair.colors)
        depth = self.apply_scaling(depth, pair.gt_depths, pair.intrinsics)
        if step == 0:
            self.initial_depths = depth.detach()
        elif self.initial_depths is None:
            self.initial_depths = torch.zeros_like(depth)  # the JAX state's zeros
        outputs = self.view_synthesis(pair, depth)
        loss, aux = self.assemble_losses(pair, disp, depth, outputs, map_state,
                                         self.initial_depths, map_index, knn_init, thread_knn)
        loss.backward()
        for p in self._zero_grads:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.scheduler.step()
        knn_cache = aux.pop("_knn_idx", None)
        with torch.no_grad():
            metrics = depth_metrics(self.config.DATA.name, pair.gt_depths[TARGET],
                                    depth[TARGET])
        metrics["total_loss"] = loss.detach()
        metrics.update({k: v.detach() for k, v in aux.items()})
        return metrics, knn_cache

    @torch.no_grad()
    def fuse_pair(self, pair: PairBatch, map_state: MapState, *, fuse_prev: bool):
        """Fuse a refined pair (prev, live) into the map (reference
        ``create_refined_pointcloud``, online_adaption.py:329-366). Returns
        (map, estimated live pose)."""
        _, depth = self.forward_depths(pair.colors)
        depth = self.apply_scaling(depth, pair.gt_depths, pair.intrinsics)
        prev = build_frame(pair.colors[0], depth[0], pair.intrinsics, pair.poses[0])
        if fuse_prev:
            map_state = self.slam._update_map(map_state, prev)
        live = build_frame(pair.colors[TARGET], depth[TARGET], pair.intrinsics,
                           pair.poses[TARGET])
        map_state, est_pose, _ = self.slam.step(map_state, live, prev)
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
        view = map_state
        if isinstance(map_index, SortedMap) and map_index.points.shape[0] < map_state.data.shape[0]:
            view = dataclasses.replace(map_state, data=map_state.data[: map_index.points.shape[0]])
        steps = []
        kc = knn_init0 if self.warm else None
        for i in range(self.refinement_steps):
            metrics, cache = self.refine_step(pair, view, map_index, knn_init=kc,
                                              thread_knn=self.warm, step=i)
            if self.warm:
                kc = cache
            steps.append(metrics)
        view, est_pose = self.fuse_pair(fuse_batch or pair, view, fuse_prev=fuse_prev)
        return dataclasses.replace(view, data=map_state.data), steps, est_pose, kc
