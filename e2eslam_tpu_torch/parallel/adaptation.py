"""Multi-sequence online adaptation, end to end.

The port of ``e2eslam_tpu/parallel/adaptation.py``: ``ParallelRefinement``
(``parallel/mesh.py``) steps N sequences in lockstep; this module runs
whole sequences on it.

  * Each sequence has its own keyframe schedule (camera-center distance,
    reference ``online_adaption.py:186-205``), so the sequences have
    different numbers of keyframe events. The schedules are padded to the
    longest; an ``active`` mask says which sequences are live at each
    event, and only their steps and fusions are committed.
  * Event 0 also fuses each sequence's first frame (``fuse_prev``).
  * With ``MODEL.compact_period`` the maps are compacted after event ``e``
    when ``(e + 1) % compact_period == 0``: projective compaction from each
    active sequence's estimated pose, active sequences only; voxel
    compaction of every sequence's map (``adaptation.py:100-126``,
    ``:197-204``).
  * Results per sequence: its keyframes, each keyframe's last-step metrics
    and abs_rel, the mean abs_rel over its own keyframes, the estimated
    keyframe poses, ATE and RPE.

Every sequence runs what ``OnlineAdaptation`` runs (``engine/adaptation.py``:
the keyframe windows, the sorted map views and their cache, the KNN warm
starts, compaction), with its own engine; the batching changes only the
network's call, so a sequence's results equal its solo run's up to the
rounding of the batched convolution (``tests/test_torch_parallel.py``).
Each sequence's window is assembled by one row gather over the stacked
frames (``ops/batched_rows.py::FLAT_ROW_OPS``, the JAX
``gather_pairs_flat``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from e2eslam_tpu_torch.engine.adaptation import KeyframeViews, keyframe_schedule, window_frames
from e2eslam_tpu_torch.engine.refine import PairBatch
from e2eslam_tpu_torch.losses.trajectory import absolute_trajectory_error, relative_pose_error
from e2eslam_tpu_torch.ops.batched_rows import FLAT_ROW_OPS
from e2eslam_tpu_torch.parallel.mesh import Mesh, ParallelRefinement, ParallelState

DISPATCH = ("whole", "event", "auto")


class _SequenceViews(KeyframeViews):
    """One sequence's map views and compaction (``KeyframeViews``)."""

    def __init__(self, config, engine, capacity: int):
        self.config, self.engine, self.capacity = config, engine, capacity
        self._views_init()


class ParallelAdaptation:
    """Adapt N independent sequences over the mesh, end to end.

    ``n_seq`` defaults to the mesh size and may be any multiple of it; the
    sequences of one device batch (``parallel/mesh.py``).
    """

    def __init__(self, config, model=None, *, map_capacity: int, mesh: Optional[Mesh] = None,
                 n_seq: Optional[int] = None, device=None):
        self.config = config
        self.par = ParallelRefinement(config, model, map_capacity=map_capacity, mesh=mesh,
                                      n_seq=n_seq, device=device)
        self.mesh = self.par.mesh
        self.n = self.par.n
        self.R = int(config.OPTIMIZATION.refinement_steps)
        self.F_ref = int(config.DEMO.get("sequence_length_refinement") or 2)
        if self.F_ref < 2:
            raise ValueError("DEMO.sequence_length_refinement must be at least 2")

    def init_state(self, weights=None) -> ParallelState:
        return self.par.init_state(weights)

    def init_maps(self):
        return self.par.init_maps()

    def run(self, state: ParallelState, sequences, *, threshold: float,
            generator: Optional[torch.Generator] = None, dispatch: str = "auto") -> Dict:
        """Adapt every sequence to the end of its schedule.

        Args:
          state: from ``init_state``; stepped in place.
          sequences: ``(colors [N, L, H, W, 3] in [0, 1], gt_depths [N, L, H,
            W, 1], intrinsics [N, 4, 4], poses [N, L, 4, 4])``, arrays or
            tensors, all N sequences (each rank takes its own).
          threshold: the keyframe distance (``DEMO.frame_threshold``).
          generator: draws each sequence's seed when given; by default
            sequence ``i`` is seeded with ``SETTINGS.seed + i``.
          dispatch: ``whole``, ``event`` or ``auto``: how the JAX runner
            dispatches the run (one program, or one per event). The port
            has no whole-run program; all three run the same per-event loop
            and give the same results.

        Returns ``{"state", "maps" (this rank's), "per_sequence" (all N, in
        order), "num_events", "refine_steps", "elapsed_s",
        "steps_per_sec"}``; ``steps_per_sec`` counts every sequence's steps
        over this rank's synchronised clock.
        """
        if dispatch not in DISPATCH:
            raise ValueError(f"dispatch must be one of {DISPATCH}, got {dispatch!r}")
        cfg, par = self.config, self.par
        dev, n, first = par.device, par.n_local, par.first
        colors, gt_depths, intrinsics, poses = sequences
        N = colors.shape[0]
        if N != self.n:
            raise ValueError(f"need {self.n} sequences, got {N}")
        poses_np = np.asarray(poses.cpu() if torch.is_tensor(poses) else poses)
        schedules = [keyframe_schedule(poses_np[i], threshold) for i in range(N)]
        counts = [len(s) for s in schedules]
        E = max(counts)
        if E == 0:
            raise ValueError("no keyframes selected in any sequence")

        seeds = None
        if generator is not None:
            seeds = torch.randint(0, 2**62, (N,), generator=generator).tolist()
        par.reseed(seeds)

        def local(x):
            x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
            return x[first:first + n].to(device=dev, dtype=torch.float32).contiguous()

        colors, gt_depths, K, poses = (local(x) for x in (colors, gt_depths, intrinsics, poses))
        own = range(first, first + n)
        views = [_SequenceViews(cfg, engine, par.map_capacity) for engine in par.engines]
        maps = self.init_maps()
        kf_hist = [[0] for _ in range(n)]
        last_kc: List[Optional[Dict]] = [None] * n
        keyframes = [[] for _ in range(n)]
        per_pair = [[] for _ in range(n)]
        est_poses = [[] for _ in range(n)]
        warm = par.engines[0].warm
        compact_period = int(cfg.MODEL.get("compact_period", 0) or 0)
        voxel = str(cfg.MODEL.get("compact_mode", "voxel") or "voxel") == "voxel"
        self._sync()
        t_start = time.perf_counter()
        for e in range(E):
            act = [e < counts[g] for g in own]
            if any(act):
                # Exhausted sequences repeat their last event; a sequence
                # with no event pads with (0, 0). Their work is not committed.
                events = [schedules[g][min(e, counts[g] - 1)] if counts[g] else (0, 0)
                          for g in own]
                windows = [window_frames(kf_hist[j], events[j][1], self.F_ref)
                           for j in range(n)]
                pairs = self._gather(colors, gt_depths, K, poses, windows)
                fuse = pairs if all(w == list(ev) for w, ev in zip(windows, events)) else \
                    self._gather(colors, gt_depths, K, poses, [list(ev) for ev in events])
                work, index, kc = list(maps), [None] * n, [None] * n
                for j in range(n):
                    if act[j]:
                        index[j], stable = views[j].map_index(e, maps[j])
                        work[j] = par.engines[j].map_view(maps[j], index[j])
                        kc[j] = last_kc[j] if (stable and warm) else None
                for r in range(self.R):
                    metrics, caches = par.refine_step(state, pairs, work, map_indices=index,
                                                      knn_init=kc, thread_knn=warm, step=r,
                                                      active=act)
                    if warm:
                        kc = caches
                work, est = par.fuse_pair(state, fuse, work, fuse_prev=e == 0, active=act)
                for j in range(n):
                    if act[j]:
                        maps[j] = dataclasses.replace(work[j], data=maps[j].data)
                        last_kc[j] = kc[j]
                        frame = events[j][1]
                        kf_hist[j].append(frame)
                        keyframes[j].append(frame)
                        per_pair[j].append(metrics[j] if self.R else None)
                        est_poses[j].append(est[j])
            if compact_period and (e + 1) % compact_period == 0:
                for j in range(n):
                    if act[j] or voxel:
                        pose = est_poses[j][-1] if est_poses[j] else None
                        frame = keyframes[j][-1] if keyframes[j] else 0
                        maps[j], done = views[j].maybe_compact(e, frame, maps[j], pose, K[j])
                        if done:
                            last_kc[j] = None
        self._sync()
        elapsed = time.perf_counter() - t_start

        results = []
        for j, g in enumerate(own):
            metrics = [None if m is None else {k: float(v) for k, v in m.items()}
                       for m in per_pair[j]]
            abs_rels = [m["abs_rel"] for m in metrics if m is not None]
            est = (torch.stack(est_poses[j]).cpu().numpy() if est_poses[j]
                   else np.zeros((0, 4, 4), np.float32))
            gt_kf = poses_np[g][np.asarray(keyframes[j], dtype=np.int64)]
            k = len(keyframes[j])
            results.append({
                "num_keyframes": k,
                "keyframes": keyframes[j],
                "metrics": metrics,
                "per_pair_abs_rel": abs_rels,
                "mean_abs_rel": float(np.mean(abs_rels)) if abs_rels else float("nan"),
                "est_poses": est,
                "ate": absolute_trajectory_error(gt_kf, est) if k >= 2 else float("nan"),
                "rpe": relative_pose_error(gt_kf, est) if k >= 2 else float("nan"),
                "map_points": int(maps[j].count),
                "compactions": views[j].compactions,
            })
        if self.mesh.size > 1:
            # The only collective of the run: every rank's results, in rank
            # order (the sequences' order).
            gathered = [None] * self.mesh.size
            dist.all_gather_object(gathered, results, group=self.mesh.group)
            results = [r for part in gathered for r in part]
        total_steps = self.R * sum(counts)
        return {
            "state": state,
            "maps": maps,
            "per_sequence": results,
            "num_events": E,
            "refine_steps": total_steps,
            "elapsed_s": elapsed,
            "steps_per_sec": total_steps / elapsed if elapsed > 0 else 0.0,
        }

    @staticmethod
    def _gather(colors, gt_depths, K, poses, frames) -> PairBatch:
        """Every local sequence's window (``frames``, one list per sequence)
        as one row gather over the stacked ``[n, L, ...]`` frames."""
        idx = torch.as_tensor(frames, dtype=torch.int64, device=colors.device)
        take = FLAT_ROW_OPS.take
        return PairBatch(colors=take(colors, idx), gt_depths=take(gt_depths, idx),
                         intrinsics=K, poses=take(poses, idx))

    def _sync(self):
        if self.par.device.type == "cuda":
            torch.cuda.synchronize(self.par.device)
