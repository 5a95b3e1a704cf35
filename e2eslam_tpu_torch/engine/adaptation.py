"""Online adaptation: keyframe selection -> per-window refinement -> fusion.

The product workload (reference ``online_adaption.py``, class ``SLAM``):
stream a sequence, select keyframes by camera-center distance, run R
refinement steps of the depth network per keyframe window, then fuse the
newest keyframe pair into the global map. Two ways, as in the JAX runner
(``adaptation.py:186-223``): the whole-sequence program
(``RefinementEngine.process_sequence``: the map's count on the device, no
host read before the end, on a card the warm events replayed as one CUDA
graph) wherever ``sequence_program_blocker`` finds nothing in its way, and
otherwise an eager loop over keyframes, the JAX package's per-keyframe loop
(``adaptation.py:225-377``), which also serves 3-frame windows, the sort
cache and its cross-keyframe seeds and the verbose per-step prints.

Around the loop: the network's weights come from the reference's files
(``MODEL.weights_init_encoder: imagenet``, ``MODEL.use_pretrained_models``)
and a resumed run's checkpoint (``MODEL.restore_checkpoint``), and the
adapted network is saved at the end (``MODEL.save_checkpoint``). With
``MODEL.compact_period`` the live map is compacted after every
``compact_period``-th fused keyframe (``MODEL.compact_mode``: voxel or
projective); ``MODEL.compact_voxel`` compacts the final map.

What the JAX runner writes, the runner writes, on either path
(``adaptation.py:172-181``, :454-478): with ``SETTINGS.log_path`` a JSONL
record of each keyframe's last-step scalars and, with
``VIZ.log_gradients``, its per-parameter gradient norms
(``viz/logging.py::ScalarLogger``); with ``DEBUG.plot`` and
``DEBUG.plot_path`` each keyframe's debug images as PNGs; with
``VIZ.profile_dir`` a ``torch.profiler`` trace of the whole run (the
program's capture and replays included), its path in the result's
``profile_trace``. The whole-sequence program carries the gradient norms
and the debug images in its buffers, as the JAX program stacks them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from e2eslam_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from e2eslam_tpu_torch.data.pipeline import load_batch, make_dataset
from e2eslam_tpu_torch.device import resolve_device, set_full_fp32
from e2eslam_tpu_torch.engine.refine import (
    PairBatch,
    RefinementEngine,
    compact_bucket,
    host_metrics,
    metrics_from_rows,
    validate_config,
)
from e2eslam_tpu_torch.ops.spatial_sort import SortedMap, regather_sorted
from e2eslam_tpu_torch.losses.trajectory import (
    absolute_trajectory_error,
    relative_pose_error,
)
from e2eslam_tpu_torch.models.convert import load_depth_weights
from e2eslam_tpu_torch.models.depth_net import make_depth_model
from e2eslam_tpu_torch.slam.compact import compact_map
from e2eslam_tpu_torch.utils import tracing
from e2eslam_tpu_torch.viz.images import dump_debug_images
from e2eslam_tpu_torch.viz.logging import ScalarLogger


def sequence_program_blocker(config, *, verbose: bool, use_sequence_program: bool = True):
    """Why a run takes the per-keyframe loop instead of the whole-sequence
    program, decided from the config before the run; None: the program
    runs. The JAX runner's conditions (``adaptation.py:191-195``): the
    program is on, the run is not verbose (its per-step prints read every
    step), 2-frame windows, an association other than the voxel hash (which
    the loop rebuilds on the host) and at least one refinement step. The
    observability outputs do not enter: the program carries them."""
    L, O = config.LOSS, config.OPTIMIZATION
    checks = (
        (not use_sequence_program, "use_sequence_program is off"),
        (verbose, "verbose run"),
        (int(config.DEMO.get("sequence_length_refinement") or 2) != 2, "F != 2 windows"),
        (str(L.get("knn_impl", "brute")) == "voxel", "LOSS.knn_impl: voxel"),
        (int(O.refinement_steps) <= 0, "no refinement steps"),
    )
    return next((why for blocked, why in checks if blocked), None)


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


class KeyframeViews:
    """One sequence's map index, keyframe by keyframe, and its periodic
    compaction: the brute KNN's sorted, bucketed view with the cached
    permutation between re-sorts (``LOSS.knn_sort_period``), or the
    engine's own index. ``OnlineAdaptation`` is one; the multi-sequence
    runner (``parallel/adaptation.py``) keeps one per sequence. Needs
    ``config``, ``engine`` and ``capacity``."""

    def _views_init(self):
        L = self.config.LOSS
        # The brute KNN's sorted, bucketed map view; the other associations
        # have no sort, no bucket and no seeds (the voxel hash is rebuilt
        # over the whole map each keyframe).
        self._bucketed_sort = (bool(L.get("knn_spatial_sort", True))
                               and bool(L.get("knn_bucket", True))
                               and self.engine.point_losses and self.engine.knn_impl == "brute")
        self._views_start()

    def _views_start(self):
        """Forget the previous run's views."""
        self._sort_cache = None  # {perm, inv, bucket, age, known}
        self._bucket_rows = 0
        self.regathers = 0
        self.sorted_at: List[int] = []
        self.compactions: List[Dict] = []

    def map_index(self, k: int, global_map, announce: bool = False):
        """Keyframe ``k``'s index over ``global_map``; with ``announce`` the
        sorted view's bucket choice is printed as the JAX loop prints it
        under ``E2ESLAM_DEBUG_BUCKET`` (adaptation.py:304-307). Returns
        (index, whether the sorted view's permutation is the previous
        keyframe's, so that its final KNN indices may seed this one)."""
        engine = self.engine
        if not self._bucketed_sort:
            return engine.build_map_index(global_map), False
        period = int(self.config.LOSS.get("knn_sort_period", 1) or 1)
        self._bucket_rows = self._bucket(global_map.count, k, self._bucket_rows, announce)
        bucket = self._bucket_rows
        if self._sort_cache_stale(period, bucket, global_map.count):
            index = engine.build_map_index(global_map, bucket)
            self.sorted_at.append(k)
            if period > 1 and isinstance(index, SortedMap):
                self._sort_cache = {"perm": index.perm, "inv": index.inv_perm,
                                    "bucket": bucket, "age": 0, "known": global_map.count}
            return index, False
        # Between re-sorts (LOSS.knn_sort_period): the cached permutation
        # over the current points, one gather.
        sc = self._sort_cache
        index = regather_sorted(global_map.points[: sc["bucket"]].detach(), sc["perm"],
                                sc["inv"])
        sc["age"] += 1
        sc["known"] = max(sc["known"], global_map.count)
        self.regathers += 1
        return index, True

    def maybe_compact(self, k: int, frame: int, global_map, est_pose, K):
        """Periodic compaction after every ``MODEL.compact_period``-th fused
        keyframe ``k``, from its camera (the JAX whole-sequence program,
        refine.py:1351-1358, and host loop, adaptation.py:402), over the
        1M-row slice that holds the valid rows (its bucket ladder,
        :1297-1327). It moves rows: the cached permutation and the seeds
        (sorted positions) no longer describe the map. Returns (map,
        whether it ran)."""
        period = int(self.config.MODEL.get("compact_period", 0) or 0)
        if not period or (k + 1) % period:
            return global_map, False
        before = global_map.count
        global_map = self.engine.compact_now(global_map, est_pose, K,
                                             bucket=compact_bucket(before, self.capacity))
        self._sort_cache = None
        self.compactions.append({"keyframe": k, "frame": frame, "before": before,
                                 "after": global_map.count})
        return global_map, True

    def _bucket(self, count: int, k: int, last: int, announce: bool) -> int:
        """Rows of the map view keyframe ``k``'s KNN and fusion run on: an
        upper bound on the post-fusion count, rounded up to
        ``LOSS.knn_bucket_quantum`` (1<<20), never shrinking within a run.
        The bound matches the JAX host loop with a ready count fetch of the
        previous keyframe (``known``, ``lag`` 1; none before the first,
        lag 2): a keyframe appends at most H*W rows."""
        cfg = self.config
        hw = int(cfg.DATA.height) * int(cfg.DATA.width)
        known, lag = (0, 2) if k == 0 else (int(count), 1)
        ub = known + (lag + 1) * hw
        q = int(cfg.LOSS.get("knn_bucket_quantum", 0) or (1 << 20))
        bucket = max(min(-(-ub // q) * q, self.capacity), last)
        if announce:
            print(f"[bucket] kf={k + 1} known={known} lag={lag} ub={ub} bucket={bucket}",
                  flush=True)
        return bucket

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


def window_frames(kf_hist: List[int], frame: int, F: int) -> List[int]:
    """The refinement window of keyframe ``frame``: the last ``F``
    keyframes ending at it, oldest first; slots older than the history
    ``kf_hist`` (processed keyframes, frame 0 the first prev) repeat the
    oldest keyframe."""
    hist = (kf_hist + [frame])[-F:]
    return [hist[0]] * (F - len(hist)) + hist


class OnlineAdaptation(KeyframeViews):
    """Config-driven online-adaptation runner.

    ``device``: ``"cpu"`` runs on the CPU; otherwise CUDA (see
    ``device.resolve_device``). ``model``: an optional depth network
    whose weights to adapt (default: the seeded initialisation).

    ``DEMO.sequence_length_refinement`` F: each keyframe refines the window
    of the last F keyframes, oldest first, with the frame at index 1 as the
    target (F = 3: the middle one, reference demo.py:437-452); fusion always
    takes the newest pair (prev, frame).

    ``use_sequence_program`` (default True, as in the JAX runner): whether a
    run whose config allows it (``sequence_program_blocker``) takes the
    whole-sequence program.

    ``run`` writes the JAX runner's observability outputs (the module's
    docstring) and returns the path of a ``VIZ.profile_dir`` trace as
    ``profile_trace``; a run that starts while a profiler records (such a
    trace, or the caller's) returns its spans and each event's phase times
    as ``trace`` (``utils/tracing.py``; None otherwise).
    """

    use_sequence_program = True

    def __init__(self, config, *, dataset=None, device=None, model=None):
        with tracing.session(), tracing.span("unit.build"):
            self._build(config, dataset, device, model)

    def _build(self, config, dataset, device, model):
        validate_config(config)
        mode = str(config.OPTIMIZATION.get("refinement", "PFT"))
        if mode != "PFT":
            # The JAX runner never reads the key and runs PFT whatever it
            # says (ROADMAP.md, section C.3); the port refuses instead.
            raise ValueError(
                f"OPTIMIZATION.refinement: {mode} is not an online mode: the online loop "
                "refines the network (PFT); run OFT with e2eslam_tpu_torch.apps.train_depth_oft "
                "and SCALE with e2eslam_tpu_torch.apps.absolute_scale")
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
        self._views_init()

    def run(self, *, verbose: Optional[bool] = None) -> Dict:
        cfg = self.config
        if verbose is None:
            verbose = bool(cfg.DEBUG.get("print_metrics", False))
        dev = self.device
        # The JAX runner starts its trace, then opens its log, then its clock
        # (adaptation.py:174-182). The trace, and tracing, hold the whole run.
        with run_trace(cfg.VIZ.get("profile_dir"), dev, str(cfg.SETTINGS.name)) as trace, \
                tracing.session() as tr:
            with tracing.span("unit.load_batch"):
                colors, gt_depths, intrinsics, poses_np, _ = load_batch(self.dataset, [0])
                colors = torch.from_numpy(colors[0]).to(dev)
                gt_depths = torch.from_numpy(gt_depths[0]).to(dev)
                poses = torch.from_numpy(poses_np[0]).to(dev)
                K = torch.from_numpy(intrinsics[0]).to(dev)
            schedule = keyframe_schedule(poses_np[0], float(cfg.DEMO.frame_threshold))

            engine = self.engine
            global_map = engine.make_empty_map()
            self._views_start()
            program = sequence_program_blocker(
                cfg, verbose=verbose, use_sequence_program=self.use_sequence_program) is None
            logger = (ScalarLogger(cfg.SETTINGS.log_path, cfg.SETTINGS.name)
                      if cfg.SETTINGS.get("log_path") else None)
            self._sync()
            t_start = time.perf_counter()
            if program:
                global_map, keyframes, metrics, est, seeded_at, info = self._run_program(
                    global_map, colors, gt_depths, K, poses, schedule)
            else:
                global_map, keyframes, metrics, est, seeded_at = self._run_loop(
                    global_map, colors, gt_depths, K, poses, schedule, verbose)
                info = {"graphs": 0, "capture_s": 0.0, "counts": None}
            self._sync()
            elapsed = time.perf_counter() - t_start
            with tracing.span("unit.summary"):
                result = self._summary(global_map, keyframes, metrics, est, seeded_at, elapsed,
                                       poses_np, intrinsics, verbose, program, info, logger)
        # VIZ.profile_dir's trace file (None without one), written as its
        # block ends.
        result["profile_trace"] = trace[0] if trace else None
        result["trace"] = tr.finish() if tr is not None else None
        return result

    def _run_program(self, global_map, colors, gt_depths, K, poses, schedule):
        """The run through ``RefinementEngine.process_sequence``: one read of
        the stacked metrics (the scalars as one table, each gradient-norm or
        image buffer as itself), poses, compaction counts and map count at
        the end; each keyframe's metrics in the loop's nested shape."""
        engine = self.engine
        prev_idx = [p for p, _ in schedule]
        keyframes = [c for _, c in schedule]
        global_map, stacked, est_t, info = engine.process_sequence(
            global_map, colors, gt_depths, K, poses, prev_idx, keyframes)
        with tracing.span("program.readback"):
            names = sorted(n for n, t in stacked.items() if t.dim() == 1)
            rows = {n: stacked[n].cpu().numpy() for n in stacked if stacked[n].dim() > 1}
            if names:
                table = tracing.read(torch.stack([stacked[n].double() for n in names]))
                rows.update(zip(names, table))
            norm_names = [n for n, _ in engine.model.named_parameters()]
            metrics = [metrics_from_rows({n: r[e] for n, r in rows.items()}, norm_names)
                       for e in range(len(keyframes))]
            kf = global_map.kf_counter
            global_map = dataclasses.replace(global_map, count=int(global_map.count),
                                             kf_counter=None if kf is None else int(kf))
            passes = info["compactions"]
            counts = torch.stack([c.pop("counts") for c in passes]).tolist() if passes else []
            for c, (before, after) in zip(passes, counts):
                c.update(frame=keyframes[c["keyframe"]], before=before, after=after)
            est = est_t.cpu().numpy()
        self.compactions = passes
        # Every event sorts the whole buffer afresh (brute path); every warm
        # event past the first takes the previous event's final KNN indices.
        if self._bucketed_sort and keyframes:
            self.sorted_at = list(range(len(keyframes)))
        seeded_at = list(range(1, len(keyframes))) if engine.warm else []
        return global_map, keyframes, metrics, est, seeded_at, info

    def _run_loop(self, global_map, colors, gt_depths, K, poses, schedule, verbose):
        """The per-keyframe loop (the JAX runner's ``adaptation.py:225-377``)."""
        engine = self.engine
        keyframes: List[int] = []
        per_pair: List[Dict] = []
        est_poses = []
        kf_hist = [0]  # processed keyframes (frame 0: the first prev)
        last_kc = None
        seeded_at = []
        # The JAX loop prints its bucket lines on its non-verbose 2-frame
        # path, the one that buckets (adaptation.py:262-307).
        announce = (bool(os.environ.get("E2ESLAM_DEBUG_BUCKET")) and not verbose
                    and self.F_ref == 2)
        for k, (prev, frame) in enumerate(schedule):
            window = window_frames(kf_hist, frame, self.F_ref)
            pair = self._batch(colors, gt_depths, K, poses, window)
            fuse_batch = None if window == [prev, frame] else self._batch(
                colors, gt_depths, K, poses, [prev, frame])
            map_index, perm_stable = self.map_index(k, global_map, announce)
            # Cross-keyframe seeds: the previous keyframe's final indices are
            # positions in the sorted view, valid while its permutation is.
            seed = last_kc if perm_stable else None
            if seed is not None:
                seeded_at.append(k)
            global_map, steps, est_pose, last_kc = engine.process_pair(
                pair, global_map, map_index, fuse_prev=k == 0, fuse_batch=fuse_batch,
                knn_init0=seed)
            global_map, compacted = self.maybe_compact(k, frame, global_map, est_pose, K)
            if compacted:
                last_kc = None
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
        metrics = [None if m is None else host_metrics(m) for m in per_pair]
        est = (torch.stack(est_poses).cpu().numpy() if est_poses
               else np.zeros((0, 4, 4), np.float32))
        return global_map, keyframes, metrics, est, seeded_at

    def _summary(self, global_map, keyframes, metrics, est, seeded_at, elapsed, poses_np,
                 intrinsics, verbose, program, info, logger) -> Dict:
        cfg, engine = self.config, self.engine
        total_steps = engine.refinement_steps * len(keyframes)
        # The JAX runner's end of run (adaptation.py:456-478): keyframe i's
        # scalars at step i, then its gradient norms; its debug images.
        if logger is not None:
            for i, m in enumerate(metrics):
                if m is not None:
                    logger.log(i, {k: v for k, v in m.items() if not isinstance(v, dict)})
                    if m.get("grad_norms"):
                        logger.log(i, m["grad_norms"], prefix="grad_norm/")
            logger.close()
        if cfg.DEBUG.get("plot") and cfg.DEBUG.get("plot_path"):
            for i, m in enumerate(metrics):
                if m is not None and "debug_images" in m:
                    dump_debug_images(m["debug_images"], cfg.DEBUG.plot_path, f"kf{i:03d}")
        if cfg.MODEL.get("save_checkpoint"):
            save_checkpoint(cfg.MODEL.save_checkpoint, engine.model, engine.optimizer,
                            meta={"keyframes": len(keyframes), "refine_steps": total_steps})
        abs_rels = [m["abs_rel"] for m in metrics if m is not None]
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
            "intrinsics": intrinsics[0],
            "ate": ate,
            "rpe": rpe,
            "regathers": self.regathers,
            "seeded_keyframes": len(seeded_at),
            "sorted_at": self.sorted_at,
            "seeded_at": seeded_at,
            "compactions": self.compactions,
            # The whole-sequence program: whether it ran, the CUDA graphs it
            # captured and their capture time (inside elapsed_s), its counts
            # (refine.py::program_counts; None for the per-keyframe loop).
            "sequence_program": program,
            "graphs": info["graphs"],
            "capture_s": info["capture_s"],
            "counts": info["counts"],
        }
        if compacted is not None:
            result["map_points_compacted"] = compacted
        if verbose:
            print(f"keyframes {len(keyframes)} mean abs_rel {result['mean_abs_rel']:.5f} "
                  f"map points {result['map_points']} ate {ate:.5f} rpe {rpe:.5f} "
                  f"refine steps/sec {result['steps_per_sec']:.2f}")
        return result

    @staticmethod
    def _batch(colors, gt_depths, K, poses, frames) -> PairBatch:
        return PairBatch(colors=colors[frames], gt_depths=gt_depths[frames], intrinsics=K,
                         poses=poses[frames])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@contextlib.contextmanager
def run_trace(profile_dir: Optional[str], device: torch.device, name: str):
    """``VIZ.profile_dir``: the block under ``torch.profiler`` (the host's
    operators, and the card's kernels on CUDA), whose trace
    ``torch.profiler.tensorboard_trace_handler`` writes into ``profile_dir``
    as the block ends, the counterpart of the JAX runner's
    ``jax.profiler`` trace. Yields a list that then holds the trace file's
    path (empty without ``profile_dir``)."""
    written: List[str] = []
    if not profile_dir:
        yield written
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(profile_dir, worker_name=name)

    def ready(prof):
        os.makedirs(profile_dir, exist_ok=True)
        before = set(os.listdir(profile_dir))
        handler(prof)
        written.extend(os.path.join(profile_dir, f)
                       for f in sorted(set(os.listdir(profile_dir)) - before))

    with torch.profiler.profile(activities=activities, on_trace_ready=ready):
        yield written
