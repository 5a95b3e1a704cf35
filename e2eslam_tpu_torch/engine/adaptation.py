"""Online adaptation: keyframe selection -> per-pair refinement -> fusion.

The product workload (reference ``online_adaption.py``, class ``SLAM``):
stream a sequence, select keyframes by camera-center distance, run R
refinement steps of the depth network per keyframe pair, then fuse the
refined pair into the global map. One eager loop over keyframes.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from e2eslam_tpu_torch.data.pipeline import load_batch, make_dataset
from e2eslam_tpu_torch.device import resolve_device, set_full_fp32
from e2eslam_tpu_torch.engine.refine import PairBatch, RefinementEngine, validate_config
from e2eslam_tpu_torch.losses.trajectory import (
    absolute_trajectory_error,
    relative_pose_error,
)
from e2eslam_tpu_torch.models.depth_net import make_depth_model
from e2eslam_tpu_torch.slam.pointclouds import empty_map


def _camera_centers(poses: np.ndarray) -> np.ndarray:
    """Reference-parity keyframe "centers" ``-R^T t`` (compute_frame_distance,
    online_adaption.py:186-205), kept verbatim for schedule parity."""
    R = poses[..., :3, :3]
    t = poses[..., :3, 3]
    return -np.einsum("...ij,...i->...j", R, t)


def keyframe_schedule(poses: np.ndarray, threshold: float):
    """Keyframe pairs [(prev, cur), ...] by camera-center distance
    (reference online_adaption.py:228-238)."""
    centers = _camera_centers(np.asarray(poses))
    events = []
    prev = 0
    for frame in range(1, len(centers)):
        if np.linalg.norm(centers[frame] - centers[prev]) > threshold:
            events.append((prev, frame))
            prev = frame
    return events


class OnlineAdaptation:
    """Config-driven online-adaptation runner.

    ``device``: ``"cpu"`` runs on the CPU; otherwise CUDA (see
    ``device.resolve_device``). ``model``: an optional ``DispResNetIndoor``
    whose weights to adapt (default: the seeded initialisation).
    """

    def __init__(self, config, *, dataset=None, device=None, model=None):
        validate_config(config)
        M = config.MODEL
        for key in ("use_pretrained_models", "restore_checkpoint", "save_checkpoint"):
            if M.get(key):
                raise NotImplementedError(
                    f"MODEL.{key}: checkpoints come with a later slice of the port")
        if str(M.get("weights_init_encoder") or "").lower() == "imagenet":
            raise NotImplementedError("MODEL.weights_init_encoder: imagenet is not ported")
        if int(config.DEMO.get("sequence_length_refinement") or 2) != 2:
            raise NotImplementedError("DEMO.sequence_length_refinement: only 2 is ported")
        self.device = resolve_device(device, config)
        set_full_fp32()
        self.config = config
        self.dataset = dataset if dataset is not None else make_dataset(config)
        model = model if model is not None else make_depth_model(config)
        seq_len = int(config.DEMO.sequence_length)
        H, W = int(config.DATA.height), int(config.DATA.width)
        self.capacity = int(M.get("map_capacity") or seq_len * H * W)
        self.engine = RefinementEngine(config, model, map_capacity=self.capacity,
                                       device=self.device)
        L = config.LOSS
        self._bucketed_sort = (bool(L.get("knn_spatial_sort", True))
                               and bool(L.get("knn_bucket", True))
                               and bool(L.three3d_loss))

    def _bucket(self, count: int, first: bool, last: int) -> int:
        """Rows of the map view the keyframe's KNN and fusion run on: an
        upper bound on the post-fusion count, rounded up to
        ``LOSS.knn_bucket_quantum`` (1<<20), never shrinking within a run.
        The bound matches the JAX host loop with a ready count fetch: a
        keyframe appends at most H*W rows (the first, which also fuses its
        prev frame, 2*H*W)."""
        cfg = self.config
        hw = int(cfg.DATA.height) * int(cfg.DATA.width)
        ub = 3 * hw if first else count + 2 * hw
        q = int(cfg.LOSS.get("knn_bucket_quantum", 0) or (1 << 20))
        return max(min(-(-ub // q) * q, self.capacity), last)

    def run(self, *, verbose: Optional[bool] = None) -> Dict:
        cfg = self.config
        if verbose is None:
            verbose = bool(cfg.DEBUG.get("print_metrics", False))
        dev = self.device
        colors, gt_depths, intrinsics, poses_np, _ = load_batch(self.dataset, [0])
        colors = torch.from_numpy(colors[0]).to(dev)
        gt_depths = torch.from_numpy(gt_depths[0]).to(dev)
        poses = torch.from_numpy(poses_np[0]).to(dev)
        K = torch.from_numpy(intrinsics[0]).to(dev)
        schedule = keyframe_schedule(poses_np[0], float(cfg.DEMO.frame_threshold))

        engine = self.engine
        global_map = empty_map(self.capacity, device=dev)
        keyframes: List[int] = []
        per_pair: List[Dict] = []
        est_poses = []
        bucket = 0
        self._sync()
        t_start = time.perf_counter()
        for k, (prev, frame) in enumerate(schedule):
            pair = PairBatch(colors=torch.stack([colors[prev], colors[frame]]),
                             gt_depths=torch.stack([gt_depths[prev], gt_depths[frame]]),
                             intrinsics=K, poses=torch.stack([poses[prev], poses[frame]]))
            if self._bucketed_sort:
                bucket = self._bucket(global_map.count, k == 0, bucket)
                map_index = engine.build_map_index(global_map, bucket)
            else:
                map_index = engine.build_map_index(global_map)
            global_map, steps, est_pose = engine.process_pair(
                pair, global_map, map_index, fuse_prev=k == 0)
            if verbose:
                for i, m in enumerate(steps):
                    print(f"frame {frame} refine_step {i} "
                          f"loss {float(m['total_loss']):.5f} "
                          f"abs_rel {float(m['abs_rel']):.5f} "
                          f"rmse {float(m['rmse']):.5f} a1 {float(m['a1']):.5f}")
            keyframes.append(frame)
            per_pair.append(steps[-1] if steps else None)
            est_poses.append(est_pose)
        self._sync()
        elapsed = time.perf_counter() - t_start
        total_steps = engine.refinement_steps * len(keyframes)

        metrics = [None if m is None else {k: float(v) for k, v in m.items()}
                   for m in per_pair]
        abs_rels = [m["abs_rel"] for m in metrics if m is not None]
        est = (torch.stack(est_poses).cpu().numpy() if est_poses
               else np.zeros((0, 4, 4), np.float32))
        gt_kf = poses_np[0][np.asarray(keyframes, dtype=np.int64)]
        if len(keyframes) >= 2:
            ate = absolute_trajectory_error(gt_kf, est)
            rpe = relative_pose_error(gt_kf, est)
        else:
            ate = rpe = float("nan")
        result = {
            "map": global_map,
            "keyframes": keyframes,
            "metrics": metrics,
            "mean_abs_rel": float(np.mean(abs_rels)) if abs_rels else float("nan"),
            "num_keyframes": len(keyframes),
            "refine_steps": total_steps,
            "elapsed_s": elapsed,
            "steps_per_sec": total_steps / elapsed if elapsed > 0 else 0.0,
            "map_points": int(global_map.count),
            "est_poses": est,
            "gt_kf_poses": gt_kf,
            "ate": ate,
            "rpe": rpe,
        }
        if verbose:
            print(f"keyframes {len(keyframes)} mean abs_rel {result['mean_abs_rel']:.5f} "
                  f"map points {result['map_points']} ate {ate:.5f} rpe {rpe:.5f} "
                  f"refine steps/sec {result['steps_per_sec']:.2f}")
        return result

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
