"""The refinement engine: one PFT gradient step, and fusion of a refined pair.

The default-config path of ``e2eslam_tpu/engine/refine.py``: per keyframe
pair, R steps of parameter fine-tuning (PFT) of the depth network --
batched depth forward, online median scaling, gt-pose view synthesis, the
masked SSIM+L1 photometric loss and the end-to-end 3D point loss against
the global map with the exact brute-force KNN -- then fusion of the refined
pair into the map.

The 3D loss threads warm starts through a keyframe's steps as the JAX
``process_pair`` does: step 0 is seeded by a strided KNN over the map's
newest rows (``tail_seed``), steps 1..R-1 by the previous step's indices,
and the query Morton permutation computed at step 0 is reused. Every seed
is re-scored inside ``ops.knn``, so the search stays exact.

Eager PyTorch needs no counterpart of the JAX whole-keyframe and
whole-sequence programs; the engine is a plain per-step loop.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from e2eslam_tpu_torch.core.camera import inverse_intrinsics
from e2eslam_tpu_torch.core.depth import indoor_disp_to_depth
from e2eslam_tpu_torch.core.projection import backproject, project
from e2eslam_tpu_torch.core.sampling import grid_sample
from e2eslam_tpu_torch.core.se3 import se3_inverse, transform_points
from e2eslam_tpu_torch.engine.optim import make_optimizer
from e2eslam_tpu_torch.losses.metrics import depth_metrics
from e2eslam_tpu_torch.losses.photometric import photometric_loss
from e2eslam_tpu_torch.losses.points import knn_points_loss
from e2eslam_tpu_torch.ops.knn import knn
from e2eslam_tpu_torch.ops.spatial_sort import SortedMap, morton_codes, sort_map_points
from e2eslam_tpu_torch.slam.fusion import frame_pointcloud
from e2eslam_tpu_torch.slam.pointclouds import MapState
from e2eslam_tpu_torch.slam.rgbd import build_frame
from e2eslam_tpu_torch.slam.slam import PointFusion

Tensor = torch.Tensor

TARGET = 1  # target-frame index within a window (reference convention)

# Flags of the JAX engine that select code this slice of the port does not
# carry; each must be off (falsy). Slices: ROADMAP.md, queue A.
_UNPORTED_LOSS_FLAGS = (
    "chamfer_distance", "knn_points", "geometric", "smoothness",
    "depth_regularizer", "supervise_depth", "auto_masking",
    "three3d_texture_gate", "three3d_debias",
)


class PairBatch(NamedTuple):
    """One adaptation window of F frames."""

    colors: Tensor  # [F, H, W, 3] in [0, 1]
    gt_depths: Tensor  # [F, H, W, 1]
    intrinsics: Tensor  # [4, 4]
    poses: Tensor  # [F, 4, 4]


def validate_config(config) -> None:
    """Refuse settings whose code paths this slice of the port lacks."""
    L, M, A = config.LOSS, config.MODEL, config.ABLATION
    bad = [f"LOSS.{k}" for k in _UNPORTED_LOSS_FLAGS if L.get(k)]
    if str(L.get("knn_impl", "brute")) != "brute":
        bad.append(f"LOSS.knn_impl={L.get('knn_impl')!r} (only brute)")
    if int(L.get("three3d_map_stride", 1) or 1) != 1:
        bad.append("LOSS.three3d_map_stride != 1")
    if int(L.get("knn_sort_period", 1) or 1) != 1:
        bad.append("LOSS.knn_sort_period != 1 (regather_sorted)")
    if str(M.get("fusion_impl", "scatter")) != "scatter":
        bad.append("MODEL.fusion_impl (only scatter)")
    if M.get("active_window"):
        bad.append("MODEL.active_window")
    for k in ("compact_period", "compact_voxel"):
        if M.get(k):
            bad.append(f"MODEL.{k} (compaction)")
    if str(A.get("scaled_depth_mode", "online")) != "online":
        bad.append("ABLATION.scaled_depth_mode (only online)")
    if str(config.OPTIMIZATION.get("refinement", "PFT")) != "PFT":
        bad.append("OPTIMIZATION.refinement (only PFT)")
    if config.OPTIMIZATION.get("fused_update"):
        bad.append("OPTIMIZATION.fused_update")
    if str(M.depth_network) != "indoor":
        bad.append("MODEL.depth_network (only indoor)")
    if not config.DATA.get("use_gt_pose", True):
        bad.append("DATA.use_gt_pose: false (estimated-pose view synthesis)")
    for k in ("scale_intrinsics", "dual_disparity"):
        if A.get(k):
            bad.append(f"ABLATION.{k}")
    if bad:
        raise NotImplementedError(
            "not ported in this slice of e2eslam_tpu_torch: " + ", ".join(bad))


def _median(x: Tensor) -> Tensor:
    """``jnp.median``: the mean of the two middle values for an even count
    (``torch.median`` returns the lower one). Differentiable."""
    s = x.reshape(-1).sort().values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def masked_point_loss(pts: Tensor, nn_pts: Tensor, w: Tensor) -> Tensor:
    """``sum(w * |pts - nn|^2) / max(sum w, 1)``, the shared reduction of
    the JAX engine's 3D losses."""
    r = pts - nn_pts
    return ((r * r).sum(dim=-1) * w).sum() / w.sum().clamp(min=1.0)


class RefinementEngine:
    """Owns the depth network, its optimizer and the SLAM front end."""

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
        self.optimizer, self.scheduler = make_optimizer(config, trainable)
        M = config.MODEL
        self.slam = PointFusion(odom=str(M.odom), dist_th=float(M.dist_th),
                                angle_th=float(M.angle_th), sigma=float(M.sigma))
        L = config.LOSS
        self.refinement_steps = int(config.OPTIMIZATION.refinement_steps)
        self.warm = (self.refinement_steps > 1 and bool(L.three3d_loss)
                     and bool(L.get("knn_warm_start", True)))

    # ------------------------------------------------------------------
    # building blocks
    # ------------------------------------------------------------------
    def forward_depths(self, colors: Tensor) -> Tuple[Tensor, Tensor]:
        """Batched depth forward of all frames (indoor network). Returns
        (disp, depth)."""
        disp = self.model(colors)
        return disp, indoor_disp_to_depth(disp)

    def apply_scaling(self, depth: Tensor, gt_depths: Tensor) -> Tensor:
        """Online median scaling (reference ``online_adaption.py:295-298``)."""
        abl = self.config.ABLATION
        if not abl.get("scaled_depth", False):
            return depth
        ms = int(abl.get("median_stride", 1) or 1)
        return depth * (_median(gt_depths[:, ::ms, ::ms]) / _median(depth[:, ::ms, ::ms]))

    def view_synthesis(self, pair: PairBatch, depth: Tensor) -> Dict:
        """Warp each source frame into the target view (gt poses)."""
        cfg = self.config
        K = pair.intrinsics[None]
        cam_points = backproject(depth[TARGET][None], inverse_intrinsics(K))
        outputs = {}
        for src in range(pair.colors.shape[0]):
            if src == TARGET:
                continue
            T = (se3_inverse(pair.poses[src]) @ pair.poses[TARGET])[None]
            grid, valid = project(cam_points, K, T)
            outputs[("synthesized_frame", src)] = grid_sample(
                pair.colors[src][None], grid,
                padding_mode=cfg.MODEL.padding_mode, align_corners=False)
            outputs[("valid_mask", src)] = valid
        return outputs

    def assemble_losses(self, pair: PairBatch, depth: Tensor, outputs: Dict,
                        map_state: Optional[MapState], map_index=None,
                        knn_init=None, thread_knn: bool = False):
        """Photometric + 3D point loss. Returns (loss, aux); with the 3D
        loss on, ``aux["_knn_idx"]`` holds this step's NN indices (and the
        query permutation when ``thread_knn``) for the next step."""
        L = self.config.LOSS
        target = pair.colors[TARGET][None]
        aux: Dict[str, Tensor] = {}
        maps = []
        for src in range(pair.colors.shape[0]):
            if src == TARGET:
                continue
            synth = outputs[("synthesized_frame", src)]
            if L.photometric_mask:
                mask = outputs[("valid_mask", src)]
                maps.append(photometric_loss(synth * mask, target * mask))
            else:
                maps.append(photometric_loss(synth, target))
        # One source frame per window (F = 2): the mean over it is the
        # JAX engine's reduction whether or not min_reprojection is set.
        optimize = torch.cat(maps, dim=-1).mean()
        loss = optimize
        aux["photometric"] = optimize

        if L.three3d_loss and map_state is not None:
            knn_l, knn_idx = self._three3d(pair, depth, map_state, map_index,
                                           knn_init, thread_knn)
            loss = loss + knn_l * float(L.three3d_loss_weight)
            aux["three3d"] = knn_l
            aux["_knn_idx"] = knn_idx
        return loss, aux

    def _three3d(self, pair, depth, map_state, map_index, knn_init, thread_knn):
        """The end-to-end 3D point loss, brute (exact) branch
        (refine.py:479-613, 702-724 of the JAX engine)."""
        L = self.config.LOSS
        frame = build_frame(pair.colors[TARGET], depth[TARGET], pair.intrinsics,
                            pair.poses[TARGET])
        live = frame_pointcloud(frame)
        stride = int(L.get("three3d_query_stride", 1))
        pts = live.points[::stride]
        msk = live.mask[::stride]
        if str(L.get("three3d_align", "relative")) == "relative":
            # The reference's quirk: the world-frame cloud is moved by the
            # target->source transform before meeting the world-frame map.
            T_rel = se3_inverse(pair.poses[0]) @ pair.poses[TARGET]
            pts = transform_points(T_rel, pts)
        sorted_map = isinstance(map_index, SortedMap)
        map_pts = (map_index.points if sorted_map else map_state.points).detach()
        count = map_state.count
        q_sg = pts.detach()
        cache: Dict[str, Tensor] = {}

        ki = None if knn_init is None else knn_init.get("three3d")
        if ki is None and sorted_map and bool(L.get("knn_seed_tail", True)):
            ki = self._tail_seed(q_sg, map_state, map_index)
        qp = None
        if thread_knn:
            qp = None if knn_init is None else knn_init.get("qperm")
            if qp is None:
                valid = torch.ones(q_sg.shape[0], dtype=torch.bool, device=q_sg.device)
                qp = torch.argsort(morton_codes(q_sg, valid), stable=True)
            cache["qperm"] = qp
        _, idx = knn_points_loss(map_pts, pts, n_gt=count, init_idx=ki, q_perm=qp)
        cache["three3d"] = idx
        # Empty-map gate: the reference skips the 3D loss on the first
        # keyframe; the KNN then returns index 0 (finite) and the gate
        # zeroes the loss.
        gate = 1.0 if count > 0 else 0.0
        return gate * masked_point_loss(pts, map_pts[idx], msk), cache

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
                    map_index=None, knn_init=None, thread_knn: bool = False):
        """One PFT step: loss, backward, Adam and the schedule.

        Returns (metrics, knn cache). Metrics are device tensors of the
        depth seen by this step's loss (before the update)."""
        self.optimizer.zero_grad(set_to_none=True)
        _, depth = self.forward_depths(pair.colors)
        depth = self.apply_scaling(depth, pair.gt_depths)
        outputs = self.view_synthesis(pair, depth)
        loss, aux = self.assemble_losses(pair, depth, outputs, map_state, map_index,
                                         knn_init, thread_knn)
        loss.backward()
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
        """Fuse a refined pair into the map (reference
        ``create_refined_pointcloud``, online_adaption.py:329-366). Returns
        (map, estimated live pose)."""
        _, depth = self.forward_depths(pair.colors)
        depth = self.apply_scaling(depth, pair.gt_depths)
        prev = build_frame(pair.colors[0], depth[0], pair.intrinsics, pair.poses[0])
        if fuse_prev:
            map_state = self.slam._update_map(map_state, prev)
        live = build_frame(pair.colors[TARGET], depth[TARGET], pair.intrinsics,
                           pair.poses[TARGET])
        map_state, est_pose = self.slam.step(map_state, live, prev)
        return map_state, est_pose

    def build_map_index(self, map_state: MapState, bucket: Optional[int] = None):
        """A Morton-sorted view of the map's first ``bucket`` rows (all
        valid rows live there) for the brute KNN, or None when the sort is
        off or no 3D loss runs."""
        L = self.config.LOSS
        if not (L.three3d_loss and bool(L.get("knn_spatial_sort", True))):
            return None
        pts = map_state.points.detach()
        if bucket is not None:
            pts = pts[:bucket]
        return sort_map_points(pts, map_state.count)

    def process_pair(self, pair: PairBatch, map_state: MapState, map_index=None,
                     *, fuse_prev: bool) -> Tuple[MapState, List[Dict], Tensor]:
        """A keyframe: R refinement steps, then fusion.

        With a bucketed sorted view (``map_index`` shorter than the buffer)
        the steps and the fusion run on the buffer's first rows, which hold
        every valid row. Returns (map, per-step metrics, estimated pose).
        """
        view = map_state
        if isinstance(map_index, SortedMap) and map_index.points.shape[0] < map_state.data.shape[0]:
            view = MapState(data=map_state.data[: map_index.points.shape[0]],
                            count=map_state.count)
        steps = []
        kc = None
        for _ in range(self.refinement_steps):
            metrics, cache = self.refine_step(pair, view, map_index,
                                              knn_init=kc, thread_knn=self.warm)
            if self.warm:
                kc = cache
            steps.append(metrics)
        view, est_pose = self.fuse_pair(pair, view, fuse_prev=fuse_prev)
        return MapState(data=map_state.data, count=view.count), steps, est_pose
