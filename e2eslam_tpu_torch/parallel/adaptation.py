"""Multi-sequence online adaptation, end to end.

The port of ``e2eslam_tpu/parallel/adaptation.py``: ``ParallelRefinement``
(``parallel/mesh.py``) steps N sequences in lockstep; this module runs
whole sequences on it.

  * Each sequence has its own keyframe schedule (camera-center distance,
    reference ``online_adaption.py:186-205``), so the sequences have
    different numbers of keyframe events. The schedules are padded to the
    longest (an exhausted sequence repeats its last event, one with no
    event pads with (0, 0)); an ``active`` mask says which sequences are
    live at each event, and only their steps and fusions are committed.
  * Event 0 also fuses each sequence's first frame (``fuse_prev``).
  * With ``MODEL.compact_period`` the maps are compacted after event ``e``
    when ``(e + 1) % compact_period == 0``: projective compaction from each
    active sequence's estimated pose, active sequences only; voxel
    compaction of every sequence's map (``adaptation.py:100-126``,
    ``:197-204``).
  * Results per sequence: its keyframes, each keyframe's last-step metrics
    (with ``VIZ.log_gradients`` its gradient norms, with ``DEBUG.plot`` its
    debug images, as the JAX runners' vmapped step gives them; the nested
    shape of ``OnlineAdaptation``'s) and abs_rel, the mean abs_rel over its
    own keyframes, the estimated keyframe poses, ATE and RPE.

Two dispatches, as the JAX runner's (``adaptation.py:326-370``):

  * ``event``, the per-event loop: every sequence runs what
    ``OnlineAdaptation``'s per-keyframe loop runs (the keyframe windows,
    the sorted, bucketed map views and their cache, the cross-keyframe KNN
    seeds, compaction), with its own engine, the active mask known on the
    host; the batching changes only the network's call, so a sequence's
    results equal its solo loop's up to the rounding of the batched
    convolution (``tests/test_torch_parallel.py``).
  * ``whole``, the program over the B local sequences (the JAX
    ``whole_run``, :208-250): each event is the JAX vmapped event body
    (:128-156) with nothing read to the host: per sequence a Morton sort of
    its whole map buffer, R PFT steps seeded by its previous event's final
    KNN indices and fusion, the networks one vmapped call, every sequence
    computing and its commits masked on the device. Its inputs (the pairs
    ``[n, 2]``, the active mask ``[n]``, the event's index) are copied from
    pinned memory into fixed device tensors, and it writes each event's
    last-step metrics into ``[n, E, ...]`` buffers (the gradient norms and
    debug images too) and the estimated poses into ``[n, E, 4, 4]``, read
    once after the last event. Its events follow
    ``engine/refine.py::event_schedule``, as
    ``RefinementEngine.process_sequence`` does for one sequence: on a CUDA
    card with E >= 3 event 0 runs eagerly on the process's side stream,
    event 1 is captured as a CUDA graph into the process's graph pool
    (``capture_graph``) and events 1..E-1 replay it; on the CPU, or with
    E <= 2, every event runs eagerly, the same code. Compaction passes are
    launched between events with no read, each over the bucket of rows
    that holds a host bound on its map's count. A ``data`` axis of D > 1
    ranks captures one graph per rank; no collective runs inside it.
  * ``auto`` takes ``event`` at 8 sequences or more (the JAX rule), and
    wherever ``engine/adaptation.py::sequence_program_blocker`` stops the
    program (3-frame windows, the voxel association, no refinement step),
    decided from the config before the run. A blocked ``whole`` raises.

Each sequence's window is assembled by one row gather over the stacked
frames (``ops/batched_rows.py::FLAT_ROW_OPS``, the JAX
``gather_pairs_flat``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from e2eslam_tpu_torch.engine.adaptation import (
    KeyframeViews,
    keyframe_schedule,
    sequence_program_blocker,
    window_frames,
)
from e2eslam_tpu_torch.engine.optim import DeviceSchedule
from e2eslam_tpu_torch.engine.refine import (
    PairBatch,
    _sync_debug,
    allocator_calls,
    capture_graph,
    event_rows,
    event_schedule,
    host_metrics,
    metrics_from_rows,
    program_counts,
    program_streams,
    store_map,
)
from e2eslam_tpu_torch.losses.trajectory import absolute_trajectory_error, relative_pose_error
from e2eslam_tpu_torch.ops.batched_rows import FLAT_ROW_OPS
from e2eslam_tpu_torch.parallel.mesh import Mesh, ParallelRefinement, ParallelState, local_rows
from e2eslam_tpu_torch.slam.pointclouds import on_device
from e2eslam_tpu_torch.utils import tracing

DISPATCH = ("whole", "event", "auto")
WHOLE_MAX_SEQ = 8  # "auto" takes the per-event loop from this many sequences (JAX :338-341)


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
        with tracing.session(), tracing.span("unit.build"):
            self.par = ParallelRefinement(config, model, map_capacity=map_capacity, mesh=mesh,
                                          n_seq=n_seq, device=device)
        self.mesh = self.par.mesh
        self.n = self.par.n
        self.R = int(config.OPTIMIZATION.refinement_steps)
        self.F_ref = int(config.DEMO.get("sequence_length_refinement") or 2)
        if self.F_ref < 2:
            raise ValueError("DEMO.sequence_length_refinement must be at least 2")

    def init_state(self, weights=None) -> ParallelState:
        with tracing.session(), tracing.span("unit.build"):
            return self.par.init_state(weights)

    def init_maps(self):
        return self.par.init_maps()

    def dispatch_mode(self, dispatch: str = "auto") -> str:
        """The dispatch a run takes (``whole`` or ``event``), decided from the
        config and ``n_seq`` alone: ``auto`` is ``event`` at WHOLE_MAX_SEQ
        sequences or more and wherever ``sequence_program_blocker`` stops
        the program, else ``whole``; a blocked ``whole`` raises."""
        if dispatch not in DISPATCH:
            raise ValueError(f"dispatch must be one of {DISPATCH}, got {dispatch!r}")
        blocker = sequence_program_blocker(self.config, verbose=False)
        if dispatch == "auto":
            return "event" if self.n >= WHOLE_MAX_SEQ or blocker else "whole"
        if dispatch == "whole" and blocker:
            raise ValueError(f"dispatch='whole' cannot run this config: {blocker} "
                             "(the per-event loop, dispatch='event', runs it)")
        return dispatch

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
          dispatch: ``whole`` (the program), ``event`` (the per-event loop)
            or ``auto`` (``dispatch_mode``).

        Returns ``{"state", "maps" (this rank's), "per_sequence" (all N, in
        order), "num_events", "refine_steps", "elapsed_s",
        "steps_per_sec", "dispatch", "graphs", "capture_s", "counts",
        "trace"}``; ``steps_per_sec`` counts every sequence's steps over this
        rank's synchronised clock, ``graphs`` and ``capture_s`` the program's
        CUDA graphs and their capture time (inside ``elapsed_s``), ``counts``
        the program's (``engine/refine.py::program_counts``; None for the
        per-event loop), ``trace``
        this rank's spans and phase timestamps when a profiler recorded as
        the run started (``utils/tracing.py``; else None).
        """
        with tracing.session() as tr:
            result = self._run(state, sequences, threshold, generator, dispatch)
        result["trace"] = tr.finish() if tr is not None else None
        return result

    def _run(self, state, sequences, threshold, generator, dispatch):
        mode = self.dispatch_mode(dispatch)
        par = self.par
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
        with tracing.span("unit.load_batch"):
            data = local_rows(self.mesh, self.n, (colors, gt_depths, intrinsics, poses), dev)
        own = list(range(first, first + n))
        self._sync()
        t_start = time.perf_counter()
        if mode == "whole":
            maps, keyframes, metrics, est, compactions, info = self._run_program(
                state, data, [schedules[g] for g in own], E)
        else:
            maps, keyframes, metrics, est, compactions = self._run_loop(
                state, data, [schedules[g] for g in own], E)
            info = {"graphs": 0, "capture_s": 0.0, "counts": None}
        self._sync()
        elapsed = time.perf_counter() - t_start
        with tracing.span("unit.summary"):
            results = []
            for j, g in enumerate(own):
                abs_rels = [m["abs_rel"] for m in metrics[j] if m is not None]
                gt_kf = poses_np[g][np.asarray(keyframes[j], dtype=np.int64)]
                k = len(keyframes[j])
                results.append({
                    "num_keyframes": k,
                    "keyframes": keyframes[j],
                    "metrics": metrics[j],
                    "per_pair_abs_rel": abs_rels,
                    "mean_abs_rel": float(np.mean(abs_rels)) if abs_rels else float("nan"),
                    "est_poses": est[j],
                    "ate": absolute_trajectory_error(gt_kf, est[j]) if k >= 2 else float("nan"),
                    "rpe": relative_pose_error(gt_kf, est[j]) if k >= 2 else float("nan"),
                    "map_points": int(maps[j].count),
                    "compactions": compactions[j],
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
                "dispatch": mode,
                "graphs": info["graphs"],
                "capture_s": info["capture_s"],
                "counts": info["counts"],
            }

    def _run_loop(self, state, data, schedules, E):
        """The per-event loop over the local sequences' ``schedules``.
        Returns (maps, keyframes, metrics, estimated poses, compactions),
        one entry per local sequence, metrics and poses on the host."""
        cfg, par = self.config, self.par
        n = par.n_local
        colors, gt_depths, K, poses = data
        counts = [len(s) for s in schedules]
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
        for e in range(E):
            act = [e < c for c in counts]
            if any(act):
                events = _padded_events(schedules, e)
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
        metrics = [[None if m is None else host_metrics(m) for m in pp] for pp in per_pair]
        est = [torch.stack(p).cpu().numpy() if p else np.zeros((0, 4, 4), np.float32)
               for p in est_poses]
        return maps, keyframes, metrics, est, [v.compactions for v in views]

    def _run_program(self, state, data, schedules, E):
        """The program over the local sequences' ``schedules`` (the JAX
        ``whole_run``). Returns (maps, keyframes, metrics, estimated poses,
        compactions, info ``{"graphs", "capture_s", "counts"}``), as
        ``_run_loop``. Its graph is created, replayed and dropped inside this
        call (the process's graph pool, ``engine/refine.py::graph_pool``)."""
        cfg, par = self.config, self.par
        dev, n = par.device, par.n_local
        cuda = dev.type == "cuda"
        calls = allocator_calls(dev)
        colors, gt_depths, K, poses = data
        counts = [len(s) for s in schedules]
        maps = [on_device(m) for m in self.init_maps()]
        events = [_padded_events(schedules, e) for e in range(E)]
        pairs_h = torch.tensor(events, dtype=torch.int64)  # [E, n, 2]
        act_h = torch.tensor([[e < c for c in counts] for e in range(E)])  # [E, n]
        ev_h = torch.arange(E, dtype=torch.int64)[:, None]
        if cuda:
            pairs_h, act_h, ev_h = pairs_h.pin_memory(), act_h.pin_memory(), ev_h.pin_memory()
        # The graph's inputs: written from pinned memory before each event.
        pi = torch.zeros(n, 2, dtype=torch.int64, device=dev)
        act = torch.zeros(n, dtype=torch.bool, device=dev)
        ev_i = torch.zeros(1, dtype=torch.int64, device=dev)
        ins = (pi, act, ev_i)
        out: Dict[str, torch.Tensor] = {}
        est = torch.zeros(n, E, 4, 4, dtype=poses.dtype, device=dev)
        carry: Dict = {}
        info = {"graphs": 0, "capture_s": 0.0}
        passes = []  # (sequence, event, device counts [2])
        period = int(cfg.MODEL.get("compact_period", 0) or 0)
        voxel = str(cfg.MODEL.get("compact_mode", "voxel") or "voxel") == "voxel"
        seq = (colors, gt_depths, K, poses)
        if cuda:
            par._schedule = DeviceSchedule(cfg, state.optimizer, state.scheduler, dev)
        kinds = event_schedule(E, cuda)
        side = program_streams(dev)[0] if cuda else None
        if cuda:
            side.wait_stream(torch.cuda.current_stream(dev))
        sync_mode = par.engines[0].replay_sync_mode
        tracing.begin_events(E, tracing.phase_names(self.R), dev,
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
                            graph = self._capture_event(state, seq, ins, maps, carry, out, est,
                                                        info)
                    if warm:
                        with tracing.span("program.replay"), _sync_debug(sync_mode):
                            self._feed(ins, pairs_h[e], act_h[e], ev_h[e])
                            graph.replay()
                    else:
                        with tracing.span("program.eager_event"):
                            self._feed(ins, pairs_h[e], act_h[e], ev_h[e])
                            self._event(state, seq, ins, maps, carry, out, est,
                                        fuse_prev=e == 0)
                    if period and (e + 1) % period == 0:
                        # The JAX ``compact_batch``: projective passes where
                        # the event was active, voxel passes for every map;
                        # each over the bucket that holds its frames' rows.
                        with tracing.span("program.compact"):
                            for j in range(n):
                                if e < counts[j] or voxel:
                                    engine = par.engines[j]
                                    fused = min(e + 1, counts[j]) + 1 if counts[j] else 0
                                    bound = engine.fused_rows_bound(0, fused)
                                    with _sync_debug(sync_mode if cuda else None):
                                        passes.append((j, e, engine.compact_in_place(
                                            maps[j], est[j, e], K[j], bound)))
            if cuda and graph is None:
                torch.cuda.current_stream(dev).wait_stream(side)
        finally:
            if par._schedule is not None:
                par._schedule.exit()
                par._schedule = None
        with tracing.span("program.readback"):
            names = sorted(k for k, t in out.items() if t.dim() == 2)
            rows = {k: out[k].cpu().numpy() for k in out if out[k].dim() > 2}
            if names:
                rows.update(zip(names, tracing.read(torch.stack([out[k].double()
                                                                 for k in names]))))
            est_np = est.cpu().numpy()
            compactions: List[List[Dict]] = [[] for _ in range(n)]
            if passes:
                for (j, e, _), (before, after) in zip(
                        passes, torch.stack([c for _, _, c in passes]).tolist()):
                    compactions[j].append({"keyframe": e, "frame": events[e][j][1],
                                           "before": before, "after": after})
            keyframes = [[c for _, c in s] for s in schedules]
            norm_names = list(state.params)
            metrics = [[metrics_from_rows({k: r[j, e] for k, r in rows.items()}, norm_names)
                        for e in range(counts[j])] for j in range(n)]
            maps = [dataclasses.replace(m, count=int(m.count),
                                        kf_counter=None if m.kf_counter is None
                                        else int(m.kf_counter)) for m in maps]
        info["counts"] = program_counts(dev, calls, kinds.count("eager"))
        tracing.count(info["counts"])
        return (maps, keyframes, metrics, [est_np[j, :counts[j]] for j in range(n)],
                compactions, info)

    @staticmethod
    def _feed(ins, pairs, act, ev) -> None:
        """One event's inputs into the program's fixed device tensors."""
        for dst, src in zip(ins, (pairs, act, ev)):
            dst.copy_(src, non_blocking=True)

    def _event(self, state, seq, ins, maps, carry, out, est, *, fuse_prev: bool) -> None:
        """One event of the program (the JAX vmapped ``event_body``,
        adaptation.py:128-156): every local sequence's pair gathered in one
        row gather, its whole map buffer sorted, R PFT steps seeded by its
        previous event's final KNN cache, then fusion, committed where the
        active mask is set. Everything it keeps is written in place (the
        maps, ``carry["kc"]``, row ``ev_i`` of ``out``'s ``[n, E, ...]``
        buffers (``event_rows``) and of ``est``), so a CUDA graph of it
        replays against the same tensors."""
        par = self.par
        pi, act, ev_i = ins
        colors, gt_depths, K, poses = seq
        take = FLAT_ROW_OPS.take
        with tracing.event(ev_i):
            with tracing.phase("event.inputs"):
                pairs = PairBatch(colors=take(colors, pi), gt_depths=take(gt_depths, pi),
                                  intrinsics=K, poses=take(poses, pi))
            with tracing.phase("event.sort"):
                index = [engine.build_map_index(m) for engine, m in zip(par.engines, maps)]
            warm = par.engines[0].warm
            kc = carry.get("kc") if warm else None
            metrics = None
            for r in range(self.R):
                metrics, caches = par.refine_step(state, pairs, maps, map_indices=index,
                                                  knn_init=kc, thread_knn=warm, step=r,
                                                  active=act)
                if warm:
                    kc = caches
            with tracing.phase("event.fusion"):
                new, est_e = par.fuse_pair(state, pairs, maps, fuse_prev=fuse_prev, active=act)
            with tracing.phase("event.rows"):
                rows = [event_rows(m) for m in metrics]
                for name in rows[0]:
                    value = torch.stack([r[name] for r in rows])
                    if name not in out:
                        out[name] = value.new_zeros(est.shape[:2] + value.shape[1:])
                    out[name].index_copy_(1, ev_i, value[:, None])
                est.index_copy_(1, ev_i, torch.stack(est_e)[:, None].to(est.dtype))
                for m, m_new in zip(maps, new):
                    store_map(m, m_new)
                if kc is not None:
                    if carry.get("kc") is None:
                        carry["kc"] = [{k: v.clone() for k, v in c.items()} for c in kc]
                    else:
                        for dst, src in zip(carry["kc"], kc):
                            for k, v in src.items():
                                dst[k].copy_(v)

    def _capture_event(self, state, seq, ins, maps, carry, out, est, info):
        """Capture one warm event (no fusion of the previous frame) as a CUDA
        graph (``engine/refine.py::capture_graph``); each sequence's random
        draws, if any, from its engine's generator."""
        L = self.config.LOSS
        graph = torch.cuda.CUDAGraph()
        if L.get("supervise_depth") or (L.get("auto_masking") and L.get("min_reprojection")):
            for engine in self.par.engines:
                graph.register_generator_state(engine.generator)
        t0 = time.perf_counter()
        capture_graph(graph, self.par.device, lambda: self._event(
            state, seq, ins, maps, carry, out, est, fuse_prev=False))
        info["capture_s"] += time.perf_counter() - t0
        info["graphs"] += 1
        return graph

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


def _padded_events(schedules, e: int):
    """Event ``e`` of every schedule: an exhausted schedule repeats its last
    event, an empty one pads with (0, 0); their work is not committed."""
    return [s[min(e, len(s) - 1)] if s else (0, 0) for s in schedules]
