"""Online adaptation: keyframe selection -> per-window refinement -> fusion.

The product workload (reference ``online_adaption.py``, class ``SLAM``):
stream a sequence, select keyframes by camera-center distance, run R
refinement steps of the depth network per keyframe window, then fuse the
newest keyframe pair into the global map. One eager loop over keyframes:
the JAX package's per-keyframe loop (``adaptation.py:225-377``), which also
serves its 3-frame windows, its sort cache and its cross-keyframe seeds.
The flagship configuration (index fusion and association) runs the same
loop where the JAX runner takes its whole-sequence program
(``adaptation.py:186-223``); the runs agree to the tolerances of
``tests/test_torch_flagship.py``.

Around the loop: the network's weights come from the reference's files
(``MODEL.weights_init_encoder: imagenet``, ``MODEL.use_pretrained_models``)
and a resumed run's checkpoint (``MODEL.restore_checkpoint``), and the
adapted network is saved at the end (``MODEL.save_checkpoint``). With
``MODEL.compact_period`` the live map is compacted after every
``compact_period``-th fused keyframe (``MODEL.compact_mode``: voxel or
projective); ``MODEL.compact_voxel`` compacts the final map.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from e2eslam_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from e2eslam_tpu_torch.data.pipeline import load_batch, make_dataset
from e2eslam_tpu_torch.device import resolve_device, set_full_fp32
from e2eslam_tpu_torch.engine.refine import PairBatch, RefinementEngine, validate_config
from e2eslam_tpu_torch.ops.spatial_sort import SortedMap, regather_sorted
from e2eslam_tpu_torch.losses.trajectory import (
    absolute_trajectory_error,
    relative_pose_error,
)
from e2eslam_tpu_torch.models.convert import load_depth_weights
from e2eslam_tpu_torch.models.depth_net import make_depth_model
from e2eslam_tpu_torch.slam.compact import compact_map

BUCKET_QUANTUM = 1 << 20


def _quantized(count: int, capacity: int) -> int:
    """``count`` rounded up to BUCKET_QUANTUM rows, at most ``capacity``."""
    return min(-(-max(count, 1) // BUCKET_QUANTUM) * BUCKET_QUANTUM, capacity)


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
    ``device.resolve_device``). ``model``: an optional depth network
    whose weights to adapt (default: the seeded initialisation).

    ``DEMO.sequence_length_refinement`` F: each keyframe refines the window
    of the last F keyframes, oldest first, with the frame at index 1 as the
    target (F = 3: the middle one, reference demo.py:437-452); fusion always
    takes the newest pair (prev, frame).
    """

    def __init__(self, config, *, dataset=None, device=None, model=None):
        validate_config(config)
        M = config.MODEL
        self.F_ref = int(config.DEMO.get("sequence_length_refinement") or 2)
        if self.F_ref < 2:
            raise ValueError("DEMO.sequence_length_refinement must be at least 2")
        self.device = resolve_device(device, config)
        set_full_fp32()
        self.config = config
        self.dataset = dataset if dataset is not None else make_dataset(config)
        model = model if model is not None else make_depth_model(config)
        # ImageNet encoder, then the task checkpoint, then a resumed run's
        # weights (e2eslam_tpu/engine/adaptation.py:72-82): the network's
        # parameters and statistics only; the saved optimizer state is not
        # restored, as the JAX runner discards it.
        load_depth_weights(config, model)
        if M.get("restore_checkpoint"):
            load_checkpoint(M.restore_checkpoint, model)
        seq_len = int(config.DEMO.sequence_length)
        H, W = int(config.DATA.height), int(config.DATA.width)
        self.capacity = int(M.get("map_capacity") or seq_len * H * W)
        self.engine = RefinementEngine(config, model, map_capacity=self.capacity,
                                       device=self.device)
        L = config.LOSS
        # The brute KNN's sorted, bucketed map view; the other associations
        # have no sort, no bucket and no seeds (the voxel hash is rebuilt
        # over the whole map each keyframe).
        self._bucketed_sort = (bool(L.get("knn_spatial_sort", True))
                               and bool(L.get("knn_bucket", True))
                               and self.engine.point_losses and self.engine.knn_impl == "brute")
        self._sort_cache = None  # {perm, inv, bucket, age, known}

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
        global_map = engine.make_empty_map()
        keyframes: List[int] = []
        per_pair: List[Dict] = []
        est_poses = []
        bucket = 0
        kf_hist = [0]  # processed keyframes (frame 0: the first prev)
        self._sort_cache = None
        period = int(cfg.LOSS.get("knn_sort_period", 1) or 1)
        last_kc = None
        regathers = 0
        sorted_at, seeded_at, compactions = [], [], []
        compact_period = int(cfg.MODEL.get("compact_period", 0) or 0)
        self._sync()
        t_start = time.perf_counter()
        for k, (prev, frame) in enumerate(schedule):
            # The last F keyframes ending at `frame`, oldest first; slots
            # older than the history repeat the oldest keyframe.
            hist = (kf_hist + [frame])[-self.F_ref:]
            window = [hist[0]] * (self.F_ref - len(hist)) + hist
            pair = self._batch(colors, gt_depths, K, poses, window)
            fuse_batch = None if window == [prev, frame] else self._batch(
                colors, gt_depths, K, poses, [prev, frame])
            perm_stable = False
            if self._bucketed_sort:
                bucket = self._bucket(global_map.count, k == 0, bucket)
                if self._sort_cache_stale(period, bucket, global_map.count):
                    map_index = engine.build_map_index(global_map, bucket)
                    sorted_at.append(k)
                    if period > 1 and isinstance(map_index, SortedMap):
                        self._sort_cache = {"perm": map_index.perm, "inv": map_index.inv_perm,
                                            "bucket": bucket, "age": 0,
                                            "known": global_map.count}
                else:
                    # Between re-sorts (LOSS.knn_sort_period): the cached
                    # permutation over the current points, one gather.
                    sc = self._sort_cache
                    map_index = regather_sorted(global_map.points[: sc["bucket"]].detach(),
                                                sc["perm"], sc["inv"])
                    sc["age"] += 1
                    sc["known"] = max(sc["known"], global_map.count)
                    perm_stable = True
                    regathers += 1
            else:
                map_index = engine.build_map_index(global_map)
            # Cross-keyframe seeds: the previous keyframe's final indices are
            # positions in the sorted view, valid while its permutation is.
            seed = last_kc if perm_stable else None
            if seed is not None:
                seeded_at.append(k)
            global_map, steps, est_pose, last_kc = engine.process_pair(
                pair, global_map, map_index, fuse_prev=k == 0, fuse_batch=fuse_batch,
                knn_init0=seed)
            if compact_period and (k + 1) % compact_period == 0:
                # Periodic compaction after every compact_period-th fused
                # keyframe, from its camera (the JAX whole-sequence program,
                # refine.py:1351-1358, and host loop, adaptation.py:402), over
                # the 1M-row slice that holds the valid rows (its bucket
                # ladder, :1297-1327). It moves rows: the cached permutation
                # and the seeds (sorted positions) no longer describe the map.
                before = global_map.count
                global_map = engine.compact_now(global_map, est_pose, K,
                                                bucket=_quantized(before, self.capacity))
                self._sort_cache = None
                last_kc = None
                compactions.append({"keyframe": k, "frame": frame, "before": before,
                                    "after": global_map.count})
            if verbose:
                for i, m in enumerate(steps):
                    print(f"frame {frame} refine_step {i} "
                          f"loss {float(m['total_loss']):.5f} "
                          f"abs_rel {float(m['abs_rel']):.5f} "
                          f"rmse {float(m['rmse']):.5f} a1 {float(m['a1']):.5f}")
            kf_hist.append(frame)
            keyframes.append(frame)
            per_pair.append(steps[-1] if steps else None)
            est_poses.append(est_pose)
        self._sync()
        elapsed = time.perf_counter() - t_start
        total_steps = engine.refinement_steps * len(keyframes)
        if cfg.MODEL.get("save_checkpoint"):
            save_checkpoint(cfg.MODEL.save_checkpoint, engine.model, engine.optimizer,
                            meta={"keyframes": len(keyframes), "refine_steps": total_steps})

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
        # End-of-run compaction (MODEL.compact_voxel): the result's map is
        # the compacted one, ``map_points`` stays the working map's size.
        raw_points = int(global_map.count)
        compacted = None
        if cfg.MODEL.get("compact_voxel"):
            global_map = compact_map(global_map, voxel=float(cfg.MODEL.compact_voxel))
            compacted = int(global_map.count)
        result = {
            "map": global_map,
            "keyframes": keyframes,
            "metrics": metrics,
            "mean_abs_rel": float(np.mean(abs_rels)) if abs_rels else float("nan"),
            "num_keyframes": len(keyframes),
            "refine_steps": total_steps,
            "elapsed_s": elapsed,
            "steps_per_sec": total_steps / elapsed if elapsed > 0 else 0.0,
            "map_points": raw_points,
            "est_poses": est,
            "gt_kf_poses": gt_kf,
            "ate": ate,
            "rpe": rpe,
            "regathers": regathers,
            "seeded_keyframes": len(seeded_at),
            "sorted_at": sorted_at,
            "seeded_at": seeded_at,
            "compactions": compactions,
        }
        if compacted is not None:
            result["map_points_compacted"] = compacted
        if verbose:
            print(f"keyframes {len(keyframes)} mean abs_rel {result['mean_abs_rel']:.5f} "
                  f"map points {result['map_points']} ate {ate:.5f} rpe {rpe:.5f} "
                  f"refine steps/sec {result['steps_per_sec']:.2f}")
        return result

    def _sort_cache_stale(self, period: int, bucket: int, known: int) -> bool:
        """Whether the cached Morton permutation must be rebuilt
        (e2eslam_tpu/engine/adaptation.py:110-129): the cache is off
        (``period <= 1``) or empty, the bucket changed (the permutation
        covers the old slice), it aged out, or the map count decreased since
        the sort (the regathered view's valid prefix needs counts that never
        shrink). ``known`` 0 means no count is known yet."""
        sc = self._sort_cache
        if period <= 1 or sc is None:
            return True
        shrunk = 0 < known < sc.get("known", 0)
        return shrunk or bucket != sc["bucket"] or sc["age"] >= period - 1

    @staticmethod
    def _batch(colors, gt_depths, K, poses, frames) -> PairBatch:
        return PairBatch(colors=colors[frames], gt_depths=gt_depths[frames], intrinsics=K,
                         poses=poses[frames])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
