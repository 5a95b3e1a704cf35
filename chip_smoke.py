#!/usr/bin/env python3
"""Drive e2eslam_tpu_torch's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure ends the script with a non-zero exit):
  1. device   the card's name and power limit;
  2. build    nvcc builds every kernel from ops/csrc/ (one process per source);
  3. kernels  each of the three KNN kernels against its plain PyTorch version
              on the same inputs, at the on-chip check shapes (cold and warm),
              at main-path-like shapes (the resident kernel cold and warm, the
              dense kernel on a cold search past the resident limit and on a
              warm call with random seeds, the candidate kernel warm and on an
              unseeded warm call whose every list is full), and the
              dispatcher's distances against a float64 oracle; every call of
              at most RES_MAX_ROWS ref rows must take the resident kernel;
     fusion   scatter PointFusion at default-seq60's shapes (a 320x256 frame
              into 4,915,200 rows, 1.5M and 3M of them valid): the CUDA
              kernels' fusion against the plain path's on the same inputs
              (equal counts, winners and appended rows, merged rows within
              1e-6, every other row's bytes kept), then the map-sized pass
              timed both ways beside its bound, and the whole fusion step;
  4. main     online adaptation from configs/config.yaml at full width
              (320x256, ResNet-18, 3 refine steps, brute three3d), only
              DEMO.sequence_length cut, with every kernel launch counted and
              the largest call of each kernel kept (and the fusion kernel's
              launches, one or more a keyframe); those calls are then held
              against the plain versions and timed; no warm call may take the
              dense kernel; on the largest resident call, the resident
              kernel's options (box size, shares of a list) are timed and
              must all give the same bits;
  5. chamfer  online adaptation with the exact bidirectional chamfer at full
              width (tools/bench_exact.py's TUM row on configs/config.yaml:
              dilation 5, 40 frames, threshold 0.12, three3d off), its
              map->frame calls (the map's rows query the frame's 81,920:
              the only calls with more query rows than a frame has pixels)
              counted apart; they must launch the resident kernel alone. The
              largest frame->map call (candidate kernel) and tail seed
              (resident kernel) are held against their plain versions; the
              largest map->frame call is held against the plain version
              (run 64 query tiles at a time), timed, and timed again through
              the candidate kernel on a table built as the dispatcher builds
              one (the ``route_options`` line), which must give the same
              scores;
  6. losses   12 frames of configs/config.yaml with the geometric,
              smoothness, depth-regularizer, auto-masking and
              min-reprojection terms, 3-frame windows, a sort period of 4,
              the texture gate and debias on: finite losses, abs_rel in
              (0, 0.5), regathered and cross-keyframe seeded keyframes
              counted; then 6 frames of the same with the monodepth2 network.
              Each run's launches are counted apart, and every KNN call of
              each run (regathered maps, cross-keyframe seeds) is held
              against its plain version;
  7. flagship the JAX package's benchmark configuration (bench.py:67-127:
              index fusion and association, the bf16 CNN, the fused Adam),
              all 60 frames at 320x256 after a 4-frame warm-up, with the
              default algorithms and then with deterministic ones: 59
              keyframes, the map within 5% of 3,968,833 points, no KNN
              launch, and for the deterministic run (the default run's
              trajectory varies too widely) mean abs_rel in 0.065-0.090
              (the JAX package's TPU run, BENCH_r05.json: a sanity band);
              the last keyframe's frame fused twice into copies of the
              final map: equal bytes;
  8. gradicp  the JAX package's trajectory row (bench.py:161-176: the
              flagship with gradICP odometry), all 60 frames after a 4-frame
              warm-up, default then deterministic algorithms: 59 keyframes,
              rigid estimated poses off the dataset's, ATE under 5.4% of the
              keyframe trajectory and RPE under 0.10 (tests/test_apps.py:
              74-102), mean abs_rel in (0, 0.5), no KNN launch; the JAX
              package's TPU row is printed as a reference line, not a check;
     odom_brute  12 frames of configs/config.yaml with gradICP odometry (the
              map the KNN kernels search is misregistered by it), with and
              without three3d_debias: every KNN call held against its plain
              version, ATE and RPE reported;
     est_pose 6 frames with DATA.use_gt_pose: false (gradICP inside every
              PFT step): finite losses and gradients on every step, and
              _source_transform on each keyframe window, card against CPU;
  9. assoc    12 frames each with LOSS.knn_impl projective and voxel (no KNN
              launch; the voxel found share reported) and with
              MODEL.active_window 200,000 (its KNN calls held against their
              plain versions);
 10. icl      the reference's ICL-NUIM configuration
              (configs/config_icl_online.yaml: 320x256, brute three3d) on the
              repository's 10-frame sequence decoded from its PNGs (the
              decoder used is printed), the network loaded from a
              depth.pth.tar of seeded weights and saved at the end: ATE under
              1e-5, the candidate and resident kernels launched and every KNN
              call held against its plain version; the saved checkpoint
              restored in a fresh runner: an equal state dict and disparity;
     compact  the flagship with a projective compaction pass every 10th
              keyframe (tools/bench_flagship_compact.py), 60 frames: 59
              keyframes, no KNN launch, the map shrinking at each of the 5
              passes (CUDA-event times printed), the first pass run again on
              the CPU on a copy of its map (counts within PROJ_COUNT_TOL,
              index images consistent); then 12 frames of configs/config.yaml
              with a voxel pass every 4th keyframe and MODEL.compact_voxel at
              the end: the keyframe after a pass sorts afresh and takes no
              seeds, every KNN call held, card and CPU passes of equal counts;
 11. offline  the offline apps at 320x256 with the indoor ResNet-18:
     train_depth  apps/train_depth on configs/config_train_depth_icl.yaml
              over the repository's ICL sequence (DATA.start 418 -> 0,
              seeded weights; 4 windows of 25 steps against each window's
              163,840-row ground-truth map): abs_rel at each window's first
              and last step, every KNN call held, the last step's gradient
              norms and tap gradients, the checkpoint restored;
     oft      apps/train_depth_oft on the same windows, every KNN call held;
              oft_window against a loop of oft_step on the first window;
     scale    apps/absolute_scale with configs/config_scale_learning.yaml's
              grid on the same windows, card and CPU: no KNN launch, the
              learned scale and bias within SCALE_TOL;
     scaling_tools  median_scaling (the ratio, card against CPU),
              test_depth_scaling (finite mean abs_rel), pose_checker;
     recover  apps/gradient_experiments on 2 frames of configs/config.yaml,
              20 steps: the loss falls, every KNN call a cold dense-kernel
              launch (163,840-row buffers) held against dense_plain, the
              largest timed (the kernels line's ``recover cold`` entry);
     demo     apps/demo on 6 frames: one snapshot per keyframe, counts never
              decreasing, the PLY and the animation HTML written to the
              git-ignored chip_smoke_out/ (emptied at the end) and read back;
 12. batched  several sequences at once (parallel/adaptation.py: the depth
              networks of all in one vmapped call): 4 synthetic sequences
              of configs/config.yaml at 320x256 (16 frames, staggered
              starts, the last frozen after its sixth frame: ragged
              schedules) against each sequence's solo OnlineAdaptation run,
              with deterministic algorithms (equal keyframes; a sequence
              alone through the runner equal to its solo run within
              BATCHED_ONE_TOL; B = 4 the same in another order of the
              sequences) and with the default ones (the path whose
              launches are counted: equal keyframes, the first two
              keyframes' abs_rel and the mean within BATCHED_FIRST_TOL and
              BATCHED_MEAN_TOL, twice the widest gaps of
              ``--batched-repeats 20``; the candidate and resident kernels
              launched, the largest call of each held); B = 1;
              the host synchronisations an
              event (``torch.cuda.set_sync_debug_mode``); the flagship
              settings at B = 4 over 12 frames (finite abs_rel, no KNN
              launch); aggregate steps/s printed for each;
     sharded  the map-sharded exact search (ops/knn_sharded.py) on one
              card: a 2,621,440-row map (4 shards of 655,360) of wall
              points, 81,920 frame points, valid counts ending mid-shard 3
              (2,500,000) and in shard 1 (shards 2-3 empty): the 4 shard
              searches one after another and their combine against the
              unsharded search (distances within the float32 bound,
              indices equal where the neighbour is unique), the sharded
              chamfer's value and frame gradient against
              losses/points.py's (SHARDED_RTOL; the gradient to its float32
              accumulation bound once float32 ties picked differently are
              accounted for, chamfer_grad_check), per-shard times, routes
              and launches; the largest shard call (dense kernel) held and
              timed (the kernels line's ``sharded shard`` entry); then one
              world-size-1 NCCL group through knn_map_sharded and
              chamfer_distance_map_sharded. More than one card is not
              exercised here: the multi-rank paths are tested on gloo;
 13. sequence the whole-sequence program (engine/refine.py::process_sequence:
              on the card event 0 eager on a side stream, then one
              CUDA graph captured at event 1 and replayed for every later event, the map's
              count on the device) against the per-keyframe loop, each of
              SEQUENCE_RUNS at 320x256, ResNet-18, R = 3, deterministic
              algorithms (the default config over 12 and 60 frames, the
              flagship over 60, gradicp over 12, compact over 60, the
              chamfer config over 12), through both: equal keyframes and
              compaction events, the first keyframe within
              SEQUENCE_FIRST_TOL; held further (the second keyframe, the
              mean within SEQUENCE_MEAN_TOL, the map within max(4, count //
              1000)) where program and loop compute the same function: the
              index path as it ships, the brute path with the KNN's seeds
              dropped and the fused Adam (the program seeds each event from
              the last one's neighbours, and its per-tensor Adam rounds the
              update differently: the shipped brute runs' gaps are
              printed); first the data path alone, the default config at learning
              rate 0, equal to the loop in every abs_rel and map point; the
              replays and the compaction passes between them run under
              set_sync_debug_mode("error"); host syncs an event for
              default_12 and compact_60, and none from event 1 to the end
              of compact_60's program; each pass's device time (CUDA
              events, ``pass_ms``); compact_voxel_12_seedless (voxel
              passes on the brute path) equal to its loop to the bit;
              launches counted as eager plus captured
              times replays (the wrappers' counts see a captured launch
              once); the captured candidate call (default_12), the captured
              map->frame resident call (chamfer_12) and a dense call on the
              former's inputs held against the plain versions with the
              counts as device tensors; steps/s with and without the
              capture time;
 14. observability  the online runner's observability outputs
              (``VIZ.log_gradients``, ``DEBUG.plot`` with no PNG, the card's
              machine having no matplotlib, ``SETTINGS.log_path``,
              ``VIZ.profile_dir``) on OBS_FRAMES frames of configs/config.yaml
              with deterministic algorithms: the observed run takes the
              whole-sequence program (one graph, replays under
              set_sync_debug_mode("error"), no host synchronisation from
              event 1 to its end), held against the observed loop as
              ``sequence`` holds its shipped rows; its JSONL holds one step
              per keyframe with every scalar metric and a finite
              ``grad_norm/`` for every parameter, 0 for the frozen ones; its
              trace parses and holds the candidate and resident ``_dc``
              kernels (counts printed beside the launches); seedless with the
              fused Adam the program's norms and images equal the loop's to
              the bit; steps/s of the observed program, the unobserved one,
              the observed loop and the traced program (default algorithms,
              printed); the CLI with ``VIZ.plot_final_step`` writes a PLY of
              min(map points, 200,000) vertices;
 15. small    the default path, the chamfer one, index fusion and
              association (float32), the flagship settings, gradICP, the
              voxel association, the ICL sequence and the compact workload
              at 64x64 on the card, with deterministic
              algorithms and with the default ones, and on the CPU (plain
              versions): the same keyframes, abs_rel and map size
              (``SMALL_CONFIGS``: float32 tolerances, and for bf16, gradICP
              and voxel twice the widest gaps of repeated card runs,
              ``python3 chip_smoke.py --small-repeats N [config ...]``, which
              runs only this phase, N times, and reports the gaps).
``python3 chip_smoke.py --phases fusion icl compact train_depth oft scale
scaling_tools recover demo batched sharded sequence small:icl ...`` runs only the
named phases
(after the build), each with its checks, and prints neither the kernels
line nor the result; ``--small-repeats N scale scaling_tools`` measures
the card-vs-CPU gaps behind SCALE_TOL, ``--batched-repeats N`` the
batched-vs-solo gaps behind BATCHED_MEAN_TOL.
The second-to-last line is the kernels' JSON line (the resident kernel has
a second entry, ``"call": "chamfer b->a"``, for its map->frame calls, the
dense kernel one for the recover phase's cold calls, ``"call": "recover
cold"``; each entry counts its launches per path, ``sequence_launches``
the sequence phase's program runs' device launches), the last line the
result.
Kernel and plain version must agree to the float32 rounding bound of the
score (``fp32_distance_bound`` in ops/knn.py, from the rows picked); where
their indices differ, each check line reports the float64 distance gaps
between the two picks, and a gap past that bound fails the run.
A kernel's ``ms`` is the device time of one wrapper call from torch.profiler:
the KNN kernel and the helper kernels the wrapper launches around it
(``kernel_ms`` is the KNN kernel alone); ``call_ms`` is the wrapper's call
as the caller waits for it (CUDA events, host enqueue included). Beside the
timed fields, each kernel's entry carries ``check_launches``
(its launches through the dispatcher in phase 3), ``visited_pairs`` (the
(query, ref) pairs the timed call scored, each counted once: the bound
counts these) with their spread over work items (``visit_max``,
``visit_mean``, each item's pairs), ``repeated_pairs`` (pairs a work item
scored that another share of its list scored too: the resident kernel's
best sub-tile in every share past the first, work beyond the bound), and
``cdist_ms`` (a chunked ``torch.cdist(...).min(1)`` over the same valid rows:
a yardstick the port never calls, not a library version of the kernel).
The weights are random, drawn from a seed; the data is the synthetic scene.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): fp32 on CUDA cores, HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
OPS_PER_PAIR = 7  # 3 FMAs (6 flops) + 1 compare per (query, ref) pair

KERNEL_INFO = {
    "dense": ("knn_dense", "e2eslam_tpu/ops/knn.py:559"),
    "cand": ("knn_cand", "e2eslam_tpu/ops/knn.py:801"),
    "resident": ("knn_resident", "e2eslam_tpu/ops/knn.py:749"),
}
SOURCE = "e2eslam_tpu_torch/ops/csrc/knn.cu"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def launch_counts(knn) -> dict:
    """Each kernel wrapper's launch count, read from ``knn.KERNELS`` (the
    wrappers themselves, whatever a Recorder has put in their place)."""
    return {k.__name__.split("_")[0]: k.launches for k in knn.KERNELS}


class Recorder:
    """Wraps the kernel wrappers of ``ops.knn``: every call goes through
    (and is counted by) the real wrapper. Per kernel it keeps the largest
    call's arguments (by visited-work proxy: query rows x ref rows) under
    ``kernel``, or under ``kernel:ba`` for a call of more than
    ``frame_rows`` query rows (the chamfer's map->frame direction: the
    map's rows query one frame; every other call's queries are a frame's
    pixels); ``count`` tallies the calls under the same keys. With
    ``keep_all``, ``all`` keeps every call's (key, arguments).
    ``warm_dense`` counts dense calls that carried warm seeds."""

    def __init__(self, knn_mod, frame_rows=None, keep_all=False):
        self.mod = knn_mod
        self.frame_rows = frame_rows
        self.keep_all = keep_all
        self.calls = {}
        self.count = {}
        self.all = []
        self.orig = {}
        self.warm_dense = 0

    def __enter__(self):
        for key in KERNEL_INFO:
            name = f"{key}_kernel"
            orig = getattr(self.mod, name)
            self.orig[name] = orig

            def rec(*args, _key=key, _orig=orig, **kw):
                out = _orig(*args, **kw)
                self.warm_dense += _key == "dense" and args[3] is not None
                size = args[0].shape[0] * args[1].shape[0]
                k = _key
                if self.frame_rows is not None and args[0].shape[0] > self.frame_rows:
                    k = f"{_key}:ba"
                self.count[k] = self.count.get(k, 0) + 1
                if k not in self.calls or size >= self.calls[k][0]:
                    self.calls[k] = (size, args)
                if self.keep_all:
                    self.all.append((_key, args))
                return out

            setattr(self.mod, name, rec)
        return self

    def __exit__(self, *exc):
        for name, orig in self.orig.items():
            setattr(self.mod, name, orig)


def keyframe_loop(runner):
    """``runner`` (an ``OnlineAdaptation``) on the per-keyframe loop: the
    phases before ``sequence`` measure the loop they measured before the
    whole-sequence program existed."""
    runner.use_sequence_program = False
    return runner


def timed(fn, reps: int):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def compare_call(knn, key, args, tag, stats, *, timing=False, plain=None, stats_key=None,
                 report=True):
    """Kernel vs plain version (``plain``, default the module's) on one
    call's arguments; the results go to ``stats[stats_key or key]``, the
    check line is printed if ``report``. Returns the kernel's scores and
    indices, and the check line."""
    import torch

    kern = getattr(knn, f"{key}_kernel")
    plain = plain or getattr(knn, f"{key}_plain")
    q4, r4 = args[0], args[1]
    nq = int(args[-3])  # a device count (the program's calls) is read here
    s_k, i_k = kern(*args)
    s_p, i_p = plain(*args)
    torch.cuda.synchronize()
    v = slice(0, nq)
    q = q4[v, :3].double()
    q2 = (q * q).sum(1)
    d_k = (q2 - 2 * s_k[v].double()).clamp(min=0)
    d_p = (q2 - 2 * s_p[v].double()).clamp(min=0)
    r = r4[:, :3].double()
    r_k, r_p = r[i_k[v].long()], r[i_p[v].long()]
    # The float32 rounding bound of the two scores, from the rows picked.
    tol = torch.maximum(knn.fp32_distance_bound(q, r_k), knn.fp32_distance_bound(q, r_p))
    err = (d_k - d_p).abs()
    if bool((err > tol).any()):
        bad = int((err > tol).sum())
        fail(f"{key} {tag}: {bad} distances differ from the plain version "
             f"(max {float(err.max()):.3g})")
    # Indices must agree wherever the nearest neighbour is unique: where they
    # differ, the two picks' float64 distances may differ by the rounding
    # bound at most (a tie in float32).
    diff = i_k[v] != i_p[v]
    gap = (((q - r_k) ** 2).sum(1) - ((q - r_p) ** 2).sum(1)).abs()[diff]
    if bool((gap > tol[diff]).any()):
        fail(f"{key} {tag}: {int((gap > tol[diff]).sum())} indices differ where the "
             f"nearest neighbour is unique (largest float64 gap {float(gap.max()):.3g})")
    st = stats.setdefault(stats_key or key, {"max_abs_err": 0.0, "checks": 0})
    st["max_abs_err"] = max(st["max_abs_err"], float(err.max()) if nq else 0.0)
    st["checks"] += 1
    n_diff = int(gap.numel())
    line = {"phase": "kernels", "kernel": key, "case": tag, "nq": nq,
            "nr": int(args[-2]), "max_abs_err": float(err.max()) if nq else 0.0,
            "max_err_over_tol": float((err / tol.clamp(min=1e-30)).max()) if nq else 0.0,
            "tol": "fp32_distance_bound (ops/knn.py)",
            "index_mismatches": n_diff,
            "mismatch_exact_ties": int((gap == 0).sum()),
            "mismatch_gap_max": float(gap.max()) if n_diff else 0.0,
            "mismatch_gap_over_tol_max":
                float((gap / tol[diff].clamp(min=1e-30)).max()) if n_diff else 0.0}
    if timing:
        line.update(measure(knn, key, args, kern, plain))
        st.update({k: line[k] for k in ("ms", "kernel_ms", "call_ms", "plain_ms", "bound_ms",
                                         "bound_by", "case", "cdist_ms", "visited_pairs",
                                         "repeated_pairs", "visit_max", "visit_mean")})
    if report:
        print(json.dumps(line), flush=True)
    return s_k, i_k, line


def measure(knn, key, args, kern, plain):
    """The wrapper's device time (every kernel one call launches: the KNN
    kernel and its helpers, from the profiler) with the KNN kernel's share,
    the wrapper's call time and the plain version's (CUDA events around a
    call, median), the pairs scored with their spread over blocks or work
    items, and the bound."""
    import torch

    q4, r4 = args[0], args[1]
    pairs, per_block, repeated = visits(getattr(knn, f"{key}_kernel"), knn, args)
    ms, kernel_ms = device_ms(lambda: kern(*args), f"knn_{key}_kernel", 10)
    call_ms = timed(lambda: kern(*args), 20)
    plain_ms = timed(lambda: plain(*args), 3)
    nbytes = sum(t.numel() * t.element_size() for t in args
                 if isinstance(t, torch.Tensor)) + q4.shape[0] * 8
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = pairs * OPS_PER_PAIR / PEAK_FP32 * 1e3
    return {"ms": ms, "kernel_ms": kernel_ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "visited_pairs": pairs, "repeated_pairs": repeated,
            "visit_max": int(per_block.max()),
            "visit_mean": float(per_block.double().mean()), "bytes": nbytes,
            "cdist_ms": timed(lambda: cdist_min(q4[:args[-3], :3], r4[:args[-2], :3]), 3)}


def visits(kern, knn, args):
    """The (query, ref) pairs one call of ``kern`` needs (each counted
    once), the pairs each work item that ran scored, and the pairs scored
    more than once (the kernels record per work item the rows staged, the
    pairs scored and the pairs another share scores too)."""
    import torch

    q4 = args[0]
    n_qt = q4.shape[0] // knn.QT
    v = torch.zeros(knn.walk_items_max(n_qt), 3, dtype=torch.int64, device=q4.device)
    kern(*args, visits=v)
    ran = v[v[:, 0] > 0]
    per = ran[:, 1] if ran.shape[0] else v[:1, 1]
    repeated = int(ran[:, 2].sum())
    return int(per.sum()) - repeated, per, repeated


def device_ms(fn, kernel: str, reps: int):
    """Device time per call of ``fn`` (every kernel it launches) and of the
    kernel named ``kernel`` alone, means over ``reps`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    # A profiling window that records no event at all is run once more (seen
    # once late in a long run, after many windows).
    for _ in range(2):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        others = named = count = 0
        for evt in prof.key_averages():
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(evt, "self_cuda_time_total", 0.0)
            if not dev_us or evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if evt.key.startswith(kernel):
                named, count = named + dev_us, count + evt.count
            else:
                others += dev_us
        if count:
            break
    if not count:
        fail(f"the profiler saw no launch of {kernel}")
    # The profiler may drop an event: the named kernel's mean is over the
    # launches it saw.
    kernel_ms = named / count / 1e3
    return kernel_ms + others / reps / 1e3, kernel_ms


def cdist_min(q, r):
    """The yardstick the port never calls: ``torch.cdist(q, r).min(1)`` over
    the valid rows, chunked so one chunk's distance matrix stays under
    2 GiB. No single PyTorch call computes a seeded exact top-1, so this is
    reported beside the kernel, not as its library time."""
    import torch

    step = max(1, (1 << 29) // max(r.shape[0], 1))
    for s in range(0, q.shape[0], step):
        torch.cdist(q[s:s + step], r).min(dim=1)


def surface_points(n, gen, noise=0.0):
    """Points on the synthetic scene's box walls (4 x 3 x 5 m), optionally
    pushed off the surface by Gaussian noise."""
    import torch

    dev = gen.device
    box = torch.tensor([4.0, 3.0, 5.0], device=dev)
    p = torch.rand(n, 3, generator=gen, device=dev) * box
    axis = torch.randint(0, 3, (n,), generator=gen, device=dev)
    side = torch.randint(0, 2, (n,), generator=gen, device=dev).float()
    p[torch.arange(n, device=dev), axis] = side * box[axis]
    if noise:
        p = p + noise * torch.randn(n, 3, generator=gen, device=dev)
    return p


def view_points(n, gen):
    """``n`` wall points near one corner of the box (x < 1.5, y < 1.5,
    z < 2 m): the surface one camera view holds, like a frame's queries."""
    p = surface_points(16 * n, gen, 0.01)
    p = p[(p[:, 0] < 1.5) & (p[:, 1] < 1.5) & (p[:, 2] < 2.0)]
    if p.shape[0] < n:
        fail("too few view points drawn")
    return p[:n].contiguous()


def dense_args(knn, q, r, init):
    """The dense kernel's arguments for a warm call, built as the dispatcher
    builds them (queries unsorted, seeds re-scored)."""
    import torch

    nq, nr = q.shape[0], r.shape[0]
    q4 = knn._pad_rows(torch.cat([q, q.new_ones(nq, 1)], 1), -(-nq // knn.QT) * knn.QT)
    r4 = knn._pad_rows(torch.cat([r, -0.5 * (r * r).sum(1, keepdim=True)], 1),
                       -(-nr // knn.RT) * knn.RT)
    r4[nr:, 3] = knn.NEG
    nn0 = r[init.long()]
    s0 = knn._pad_rows((q * nn0).sum(1) - 0.5 * (nn0 * nn0).sum(1), q4.shape[0], knn.NEG)
    i0 = knn._pad_rows(init.int(), q4.shape[0])
    return (q4, r4, knn._tile_boxes(r4[:, :3], knn.RT), s0, i0, nq, nr, knn.RT)


def phase_kernels(knn, spatial_sort, stats):
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def oracle(q, r, nr):
        """float64 brute force (the tools/knn_tpu_check.py oracle)."""
        q, r = q.double(), r[:nr].double()
        best = torch.empty(q.shape[0], dtype=torch.float64, device=dev)
        r2 = (r * r).sum(1)
        for s in range(0, q.shape[0], 4096):
            blk = (q[s:s + 4096] ** 2).sum(1, keepdim=True) - 2 * q[s:s + 4096] @ r.T + r2
            best[s:s + 4096] = blk.min(1).values
        return best

    def dispatch(q, r, *args, **kw):
        """``knn.knn``, adding its launches to each kernel's phase-3 count; a
        call of at most RES_MAX_ROWS ref rows must take the resident kernel."""
        before = launch_counts(knn)
        out = knn.knn(q, r, *args, **kw)
        used = {key: n - before[key] for key, n in launch_counts(knn).items()}
        for key, n in used.items():
            st = stats.setdefault(key, {"max_abs_err": 0.0, "checks": 0})
            st["check_launches"] = st.get("check_launches", 0) + n
        if -(-r.shape[0] // knn.RT) * knn.RT <= knn.RES_MAX_ROWS and used != {
                "dense": 0, "cand": 0, "resident": 1}:
            fail(f"a {r.shape[0]}-row call left the resident kernel: {used}")
        return out

    def check_dispatch(tag, q, r, nr=None, init=None, qperm=None, timing=False):
        with Recorder(knn) as rec:
            d, i = dispatch(q, r, nr, init_idx=init, q_perm=qperm)
        torch.cuda.synchronize()
        nr_ = r.shape[0] if nr is None else nr
        if nr_ * q.shape[0] <= 4e9:
            want = oracle(q, r, nr_)
            tol = knn.fp32_distance_bound(q.double(), r[i.long()].double())
            if bool(((d.double() - want).abs() > tol).any()):
                fail(f"dispatcher {tag}: distances differ from the float64 oracle")
            via = ((q.double() - r[i.long()].double()) ** 2).sum(1)
            if bool(((via - want).abs() > tol).any()) or bool((i >= nr_).any()):
                fail(f"dispatcher {tag}: an index is not a nearest neighbour")
        for key, (_, args) in rec.calls.items():
            compare_call(knn, key, args, tag, stats, timing=timing)
        return d, i, set(rec.calls)

    # The on-chip check shapes of tools/knn_tpu_check.py, cold and warm.
    for nq, nr in [(1000, 5000), (256, 1024), (20480, 100000), (333, 777)]:
        q = torch.rand(nq, 3, generator=gen, device=dev) * 4 - 2
        r = torch.rand(nr, 3, generator=gen, device=dev) * 4 - 2
        _, i, _ = check_dispatch(f"{nq}x{nr} cold", q, r)
        mixed = torch.where(torch.rand(nq, generator=gen, device=dev) < 0.5, i,
                            torch.full_like(i, -1))
        check_dispatch(f"{nq}x{nr} warm", q, r, init=mixed)
        check_dispatch(f"{nq}x{nr} nr/2", q, r, nr=nr // 2)

    # Main-path-like shapes: 81,920 queries near the scene's surfaces.
    q = surface_points(81920, gen, 0.01)
    r = surface_points(65536, gen)
    check_dispatch("81920x65536 cold", q, r, timing=True)
    # Warm, half the seeds random rows and half none: the JAX package's
    # chamfer map->frame direction takes the resident kernel warm. (Its own
    # generator leaves the inputs drawn after it unchanged.)
    g1 = torch.Generator(device=dev).manual_seed(1)
    seeds = torch.randint(0, r.shape[0], (q.shape[0],), generator=g1, device=dev)
    none = torch.rand(q.shape[0], generator=g1, device=dev) < 0.5
    check_dispatch("81920x65536 warm", q, r, init=torch.where(none, -1, seeds).int(),
                   timing=True)
    r = surface_points(196608, gen)
    approx = torch.randint(0, r.shape[0], (q.shape[0],), generator=gen, device=dev)
    _, _, used = check_dispatch("81920x196608 warm", q, r, init=approx.int(), timing=True)
    if used != {"cand"}:
        fail(f"the 196,608-row warm search launched {sorted(used)}, not the candidate "
             "kernel alone")
    # The dense kernel on the same warm call, as the dispatcher before the
    # candidate table's wide tier built it (queries unsorted).
    compare_call(knn, "dense", dense_args(knn, q, r, approx), "81920x196608 warm, dense",
                 stats, timing=True)
    n_map = 1_500_000
    pts = surface_points(n_map, gen)
    sm = spatial_sort.sort_map_points(pts, n_map)
    qv = view_points(81920, gen)
    _, coarse = dispatch(qv, sm.points[::16].contiguous())  # a strided seed pass
    seed = (coarse.long() * 16).int()
    _, _, used = check_dispatch("81920x1.5M sorted warm", qv, sm.points, init=seed,
                                timing=True)
    if "cand" not in used:
        fail("the 1.5M-row seeded search did not take the candidate kernel")
    # A cold search past the resident limit: the dense kernel's remaining role.
    _, _, used = check_dispatch("81920x300000 cold", q, sm.points[:300000], timing=True)
    if used != {"dense"}:
        fail(f"the 300,000-row cold search launched {sorted(used)}, not the dense kernel")
    # Unseeded warm queries list every tile for every query tile (the table
    # overflow that used to fall back to dense): the candidate kernel takes
    # them, its full lists split over several blocks.
    none = torch.full((q.shape[0],), -1, dtype=torch.int32, device=dev)
    _, _, used = check_dispatch("81920x300000 unseeded warm", q, sm.points[:300000],
                                init=none, timing=True)
    if used != {"cand"}:
        fail(f"the unseeded warm call launched {sorted(used)}, not the candidate kernel")


# default-seq60's scatter fusion: a 320x256 frame into a buffer of 60
# frames' rows, at two of the counts a unit passes through.
FUSION_HW = (256, 320)
FUSION_ROWS = 60 * 256 * 320
FUSION_COUNTS = (1_500_000, 3_000_000)
FUSION_REPS = 20


def fusion_scene(count, N, seed=21, H=FUSION_HW[0], W=FUSION_HW[1], device="cuda"):
    """An H x W live frame of a bumpy wall (a patch of invalid depth, a
    camera pose off the identity) on ``device`` and a map of ``N`` rows
    with a host count, the first ``count`` valid: 70% near the frame's
    surface with noisy normals (merges, and failures of both gates), a
    tenth of those duplicated (ties: the lower row wins), the rest off the
    surface; zeros past the count."""
    import numpy as np
    import torch

    from e2eslam_tpu_torch.slam.fusion import frame_pointcloud
    from e2eslam_tpu_torch.slam.pointclouds import MapState
    from e2eslam_tpu_torch.slam.rgbd import build_frame

    rng = np.random.default_rng(seed)
    f = 0.8 * W
    K4 = torch.tensor([[f, 0, W / 2, 0], [0, f, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    depth = 2.0 + 1.28 * xs / W + 0.1 * np.sin(12.8 * ys / H) + 0.002 * rng.normal(size=(H, W))
    depth[H // 12:H // 4, W // 8:W // 3] = 0.0
    c, s = np.cos(0.1), np.sin(0.1)
    pose = np.array([[c, 0, s, 0.1], [0, 1, 0, -0.05], [-s, 0, c, 0.2], [0, 0, 0, 1]])
    dev = torch.device(device)
    frame = build_frame(torch.from_numpy(rng.random((H, W, 3)).astype(np.float32)).to(dev),
                        torch.from_numpy(depth[..., None].astype(np.float32)).to(dev),
                        K4.to(dev), torch.from_numpy(pose.astype(np.float32)).to(dev))
    live = frame_pointcloud(frame)
    pts, nrm = live.points.cpu().numpy(), live.normals.cpu().numpy()
    valid = np.flatnonzero(live.mask.cpu().numpy() > 0)
    data = np.zeros((N, 16), np.float32)
    near = int(0.7 * count)
    px = rng.choice(valid, near)
    data[:near, 0:3] = pts[px] + 0.02 * rng.normal(size=(near, 3))
    n = nrm[px] + 0.25 * rng.normal(size=(near, 3))
    data[:near, 3:6] = n / np.linalg.norm(n, axis=1, keepdims=True)
    dup = rng.choice(near, near // 10) if near else np.zeros(0, np.int64)
    data[near:near + dup.size] = data[dup]
    rest = count - near - dup.size
    data[near + dup.size:count, 0:3] = pts[rng.choice(valid, rest)] + rng.normal(size=(rest, 3))
    n = rng.normal(size=(rest, 3))
    data[near + dup.size:count, 3:6] = n / np.linalg.norm(n, axis=1, keepdims=True)
    data[:count, 6:9] = rng.random((count, 3))
    data[:count, 9] = rng.uniform(0.5, 3.0, count)
    return MapState(data=torch.from_numpy(data).to(dev), count=count), frame


def fusion_gaps(before, kern, plain) -> dict:
    """The kernel path's fusion against the plain path's on the same inputs:
    counts, the rows that won on one path only (their confidence changed),
    the appended rows, whether the rows past the count stayed zeros, the
    largest gap of a merged row, whether the kernel kept every other row's
    bytes, and the largest gap of those rows' normals to the plain path's
    renormalised ones, in ulps."""
    import torch

    cb, ck, cp = int(before.count), int(kern.count), int(plain.count)
    b, k, p = before.data, kern.data, plain.data
    won_k, won_p = k[:cb, 9] != b[:cb, 9], p[:cb, 9] != b[:cb, 9]
    out = {"count": ck, "plain_count": cp, "merged": int(won_k.sum()), "appended": ck - cb,
           "rows_differ": int((won_k ^ won_p).sum())}
    both = won_k & won_p
    out["merged_gap"] = float((k[:cb][both] - p[:cb][both]).abs().max()) if both.any() else 0.0
    out["appended_equal"] = ck == cp and torch.equal(k[cb:ck], p[cb:cp])
    out["tail_zero"] = not (k[ck:].any() or p[cp:].any())
    keep = ~won_k
    out["kept_bytes"] = torch.equal(k[:cb][keep], b[:cb][keep])
    kn, pn = k[:cb][keep, 3:6], p[:cb][keep, 3:6]
    ulp = torch.nextafter(pn.abs(), torch.full_like(pn, float("inf"))) - pn.abs()
    out["kept_normal_ulps"] = float(((kn - pn).abs() / ulp).max())
    return out


def profile_ms(fn, reps):
    """Device ms per call of ``fn``, in all and by kernel name (every kernel,
    memset and copy it launches; torch.profiler, mean over ``reps`` calls),
    and the call's ms between CUDA events (host enqueue included)."""
    import torch

    fn()
    torch.cuda.synchronize()
    by = {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us and evt.device_type == torch.autograd.DeviceType.CUDA:
            by[evt.key] = by.get(evt.key, 0.0) + dev_us / reps / 1e3
    if not by:
        fail("the profiler saw no device time")
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return sum(by.values()), by, t0.elapsed_time(t1) / reps


def phase_fusion():
    """Scatter PointFusion at default-seq60's shapes, at FUSION_COUNTS valid
    rows of FUSION_ROWS: the kernel path (``ops/pointfusion.py``) against
    the plain path on the same inputs (``fusion_gaps``), then the map-sized
    pass timed both ways and the kernel path's whole fusion step. The
    bound: each valid row's first 32-byte sector and 128 bytes a pixel at
    PEAK_BYTES. Returns the kernel's launches in the checks."""
    import dataclasses

    import torch

    from e2eslam_tpu_torch.ops.pointfusion import fusion_kernel
    from e2eslam_tpu_torch.slam import fusion
    from e2eslam_tpu_torch.slam.pointclouds import on_device

    H, W = FUSION_HW
    launches, stats = 0, []
    for count in FUSION_COUNTS:
        m, frame = fusion_scene(count, FUSION_ROWS)
        m = on_device(m)
        n0 = fusion_kernel.launches
        with torch.no_grad():
            kern = fusion.pointfusion_step(dataclasses.replace(m, data=m.data.clone()), frame)
            plain = fusion._pointfusion_step(m, frame, 0.05, 20.0, 0.6, None, None,
                                             inplace=False)
        launches += fusion_kernel.launches - n0
        gaps = fusion_gaps(m, kern, plain)
        del kern, plain
        live = fusion.frame_pointcloud(frame)
        alpha = fusion._pixel_alpha(H, W, frame.intrinsics, 0.6) * live.mask
        args = (frame, live, alpha, 0.05, 20.0, None, None)
        work = dataclasses.replace(m, data=m.data.clone())
        with torch.no_grad():
            pass_ms, by, pass_call_ms = profile_ms(lambda: fusion._merge_kernel(work, *args),
                                                   FUSION_REPS)
            plain_ms, _, plain_call_ms = profile_ms(
                lambda: fusion._merge_plain(work, *args, inplace=True), FUSION_REPS)
            step_ms, _, step_call_ms = profile_ms(lambda: fusion.pointfusion_step(work, frame),
                                                  FUSION_REPS)
        assoc = sum(v for k, v in by.items() if "pointfusion_associate" in k)
        merge = sum(v for k, v in by.items() if "pointfusion_merge" in k)
        bound_ms = (count * 32 + H * W * 128) / PEAK_BYTES * 1e3
        line = {"phase": "fusion", "rows": FUSION_ROWS, "hw": H * W, **gaps,
                "kernel_ms": assoc + merge, "associate_ms": assoc, "merge_ms": merge,
                "pass_ms": pass_ms, "pass_call_ms": pass_call_ms, "plain_pass_ms": plain_ms,
                "plain_pass_call_ms": plain_call_ms, "step_ms": step_ms,
                "step_call_ms": step_call_ms, "bound_ms": bound_ms,
                "share": bound_ms / (assoc + merge), "pass_ops": by}
        print(json.dumps(line), flush=True)
        stats.append(line)
        if gaps["count"] != gaps["plain_count"] or gaps["rows_differ"] or not (
                gaps["appended_equal"] and gaps["tail_zero"] and gaps["kept_bytes"]) or (
                gaps["merged_gap"] > 1e-6 or gaps["kept_normal_ulps"] > 2):
            fail(f"the fusion kernel parts from the plain path at count {count}: {gaps}")
    if launches != len(FUSION_COUNTS):
        fail(f"the fusion kernel launched {launches} times for {len(FUSION_COUNTS)} calls")
    return launches, stats


def phase_main(knn, stats):
    import torch

    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    cfg = load_yaml(default_config_path())
    cfg.DEMO.sequence_length = 12  # the only cut: ~10 keyframes
    runner = keyframe_loop(OnlineAdaptation(cfg))  # CUDA: the entry point's default
    from e2eslam_tpu_torch.ops.pointfusion import fusion_kernel

    for k in knn.KERNELS:
        k.launches = 0
    fusions = fusion_kernel.launches
    torch.cuda.reset_peak_memory_stats()
    with Recorder(knn) as rec:
        result = runner.run(verbose=False)
    launches = launch_counts(knn)
    fusions = fusion_kernel.launches - fusions
    for i, (frame, m) in enumerate(zip(result["keyframes"], result["metrics"])):
        print(json.dumps({"phase": "main", "keyframe": i, "frame": frame,
                          "loss": m["total_loss"], "photometric": m["photometric"],
                          "three3d": m["three3d"], "abs_rel": m["abs_rel"]}), flush=True)
    summary = {"phase": "main", "keyframes": result["num_keyframes"],
               "refine_steps": result["refine_steps"], "map_points": result["map_points"],
               "mean_abs_rel": result["mean_abs_rel"], "elapsed_s": result["elapsed_s"],
               "steps_per_sec": result["steps_per_sec"],
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": launches, "fusion_launches": fusions, "capacity": runner.capacity}
    print(json.dumps(summary), flush=True)
    if fusions < result["num_keyframes"]:
        fail(f"{fusions} fusion kernel launches for {result['num_keyframes']} keyframes")
    losses = [m["total_loss"] for m in result["metrics"]]
    if not result["metrics"] or not all(map(_finite, losses)):
        fail(f"non-finite or missing losses: {losses}")
    if not (0.0 < result["mean_abs_rel"] < 0.5):
        fail(f"mean abs_rel {result['mean_abs_rel']} outside (0, 0.5)")
    if not (0 < result["map_points"] <= runner.capacity):
        fail(f"map points {result['map_points']}")
    rows = result["map"].data[: result["map_points"]]
    if not bool(torch.isfinite(rows).all()):
        fail("non-finite map rows")
    for key in ("resident", "cand"):
        if launches[key] == 0:
            fail(f"the main path launched no {key} kernel")
    if rec.warm_dense:
        fail(f"{rec.warm_dense} warm calls of the main path took the dense kernel")
    # The largest main-path call of each kernel: kernel vs plain, timed.
    for key, (_, args) in rec.calls.items():
        compare_call(knn, key, args, "main path", stats, timing=True)
    resident_options(knn, rec.calls["resident"][1])
    return launches, summary


# (split_min, max_splits) of the resident kernel's list; ops/knn.py's
# RES_SPLIT_MIN, RES_MAX_SPLITS are one of them.
RES_OPTIONS = ((8, 1), (8, 2), (8, 4), (4, 8), (2, 16))


def resident_options(knn, args):
    """The resident kernel's options on one call: a box per staged chunk (as
    the dispatcher gives them) or per sub-tile (every chunk given its
    sub-tile's box), and each way in RES_OPTIONS to split a query group's
    list. Per option: the pairs needed and repeated, their spread over work
    items, and the time (CUDA events around 20 back-to-back calls, over 20,
    median of 5). Every option must give the same bits. These launches go
    to the kernel directly, past the wrapper's count."""
    import torch

    q4, r4, rbb, s0, i0, nq, nr, st = args
    S = r4.shape[0] // st
    sub = knn._subtile_boxes(rbb, S)
    sub = torch.cat([sub, torch.zeros_like(sub[:, :2])], 1)
    boxes = {"chunk": rbb, "sub-tile": sub.repeat_interleave(rbb.shape[0] // S, 0).contiguous()}
    first = None
    for box, bb in boxes.items():
        for opt in RES_OPTIONS:
            def call(*a, visits=None, _opt=opt):
                return knn._walk("knn_resident_launch", *a, visits, splits=_opt)

            a = (q4, r4, bb, s0, i0, nq, nr, st)
            out = call(*a)
            if first is None:
                first = out
            if not all(torch.equal(x[:nq], y[:nq]) for x, y in zip(out, first)):
                fail(f"the resident kernel's option {box} boxes, {opt} changed the result")
            pairs, per, repeated = visits(call, knn, a)
            ms = timed(lambda: [call(*a) for _ in range(20)], 5) / 20
            print(json.dumps({"phase": "resident_options", "boxes": box, "split_min": opt[0],
                              "max_splits": opt[1], "nq": nq, "nr": nr, "visited_pairs": pairs,
                              "repeated_pairs": repeated, "work_items": int(per.numel()),
                              "visit_max": int(per.max()),
                              "visit_mean": float(per.double().mean()), "ms": ms,
                              "bound_ms": pairs * OPS_PER_PAIR / PEAK_FP32 * 1e3}), flush=True)

def resident_plain_by_tiles(knn, tiles=64):
    """``resident_plain`` run ``tiles`` query tiles at a time (a query
    tile's list depends on that tile alone, so the result is the whole
    call's): a map-sized call's plain version in bounded memory."""
    import torch

    def plain(q4, r4, rbb, s0, i0, nq, nr, st):
        step = tiles * knn.QT
        parts = [knn.resident_plain(q4[a:a + step], r4, rbb, None if s0 is None else s0[a:a + step],
                                    None if i0 is None else i0[a:a + step],
                                    max(0, min(step, nq - a)), nr, st)
                 for a in range(0, q4.shape[0], step)]
        return tuple(torch.cat(t) for t in zip(*parts))

    return plain


def phase_chamfer(knn, stats):
    import torch

    from e2eslam_tpu_torch.apps.profile_adaptation import chamfer_config
    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    cfg = chamfer_config(load_yaml(default_config_path()))  # no cut: all 40 frames
    runner = keyframe_loop(OnlineAdaptation(cfg))
    for k in knn.KERNELS:
        k.launches = 0
    with Recorder(knn, frame_rows=int(cfg.DATA.height) * int(cfg.DATA.width)) as rec:
        result = runner.run(verbose=False)
    launches = launch_counts(knn)
    ba = {key: rec.count.get(f"{key}:ba", 0) for key in KERNEL_INFO}
    for i, (frame, m) in enumerate(zip(result["keyframes"], result["metrics"])):
        print(json.dumps({"phase": "chamfer", "keyframe": i, "frame": frame,
                          "loss": m["total_loss"], "chamfer": m["chamfer"],
                          "abs_rel": m["abs_rel"]}), flush=True)
    summary = {"phase": "chamfer", "keyframes": result["num_keyframes"],
               "refine_steps": result["refine_steps"], "map_points": result["map_points"],
               "mean_abs_rel": result["mean_abs_rel"], "elapsed_s": result["elapsed_s"],
               "steps_per_sec": result["steps_per_sec"], "launches": launches,
               "ba_launches": ba, "capacity": runner.capacity}
    print(json.dumps(summary), flush=True)
    losses = [m["total_loss"] for m in result["metrics"]]
    if not result["metrics"] or not all(map(_finite, losses)):
        fail(f"chamfer: non-finite or missing losses: {losses}")
    if not (0.0 < result["mean_abs_rel"] < 0.5):
        fail(f"chamfer: mean abs_rel {result['mean_abs_rel']} outside (0, 0.5)")
    if not result["metrics"][-1]["chamfer"] > 0:
        fail("chamfer: the last keyframe's chamfer loss is not positive")
    if ba != {"dense": 0, "cand": 0, "resident": result["refine_steps"]}:
        fail(f"chamfer: the map->frame calls launched {ba}, not the resident kernel "
             f"once in each of {result['refine_steps']} steps")
    for key in ("cand", "resident"):
        if key not in rec.calls:
            fail(f"chamfer: no frame->map call launched the {key} kernel")
    if rec.warm_dense:
        fail(f"chamfer: {rec.warm_dense} warm calls took the dense kernel")
    # The largest frame->map call (a->b, candidate kernel) and tail seed
    # (resident kernel) against their plain versions; then the largest
    # map->frame call against its plain version (by query tiles), timed,
    # with the candidate route on the same inputs.
    compare_call(knn, "cand", rec.calls["cand"][1], "chamfer a->b", stats)
    compare_call(knn, "resident", rec.calls["resident"][1], "chamfer tail seed", stats)
    args = rec.calls["resident:ba"][1]
    out = compare_call(knn, "resident", args, "chamfer b->a", stats, timing=True,
                       plain=resident_plain_by_tiles(knn), stats_key="resident_ba")
    stats["resident_ba"]["launches"] = ba["resident"]
    route_options(knn, args, out[:2], stats["resident_ba"]["bound_ms"])
    return launches, summary


def route_options(knn, args, resident_out, bound_ms):
    """The candidate kernel on a resident call's inputs, with the table the
    dispatcher would build for it (ref tiles of RT_CAND rows whose box gap
    is below each query tile's seeded worst-best distance, best first): it
    must give the resident kernel's scores bit for bit. Both wrappers timed
    with CUDA events (median of 5 over 3 back-to-back calls); the table's
    build is timed apart. The work is the resident call's, so its bound is
    too (``bound_ms``, from the call's pairs needed): the candidate
    route's share is ``bound_ms / cand_ms``. Run after the path's launch
    counts are read."""
    import torch

    q4, r4, rbb, s0, i0, nq, nr, st = args
    rt = knn.RT_CAND

    def table():
        return knn.cand_table(q4, s0, r4[:, :3], nq, nr, rt)

    rbb_c, order, counts = table()

    def cand():
        return knn.cand_kernel(q4, r4, rbb_c, s0, i0, order, counts, nq, nr, rt)

    s_c, i_c = cand()
    s_r, i_r = resident_out
    same = bool(torch.equal(s_c[:nq], s_r[:nq]))
    diff = int((i_c[:nq] != i_r[:nq]).sum())
    line = {"phase": "route_options", "call": "chamfer b->a", "nq": nq, "nr": nr,
            "same_scores": same, "index_mismatches": diff,
            "resident_ms": timed(lambda: [knn.resident_kernel(*args) for _ in range(3)], 5) / 3,
            "cand_ms": timed(lambda: [cand() for _ in range(3)], 5) / 3,
            "cand_table_ms": timed(table, 5),
            "table_entries": int(counts.sum()), "table_width": int(order.shape[1]),
            "bound_ms": bound_ms}
    line["share"] = bound_ms / line["cand_ms"]
    print(json.dumps(line), flush=True)
    if not same:
        fail("the candidate route changed a score of the chamfer's map->frame call")
    if diff:
        # Equal scores, other rows: only an exact float32 tie may do that.
        q, r = q4[:nq, :3].double(), r4[:, :3].double()
        d = (i_c[:nq] != i_r[:nq])
        gap = (((q - r[i_c[:nq].long()]) ** 2).sum(1) - ((q - r[i_r[:nq].long()]) ** 2).sum(1))
        tol = knn.fp32_distance_bound(q, r[i_r[:nq].long()])
        if bool((gap.abs()[d] > tol[d]).any()):
            fail("the candidate route picked another neighbour where it is unique")


def hold_calls(knn, rec, stats, label):
    """Every KNN call a Recorder kept (``keep_all``) against its plain
    version; one summary line per kernel, tagged with ``label``'s keys."""
    held = {}
    tag = " ".join(str(v) for v in label.values())
    for key, args in rec.all:
        chk = compare_call(knn, key, args, tag, stats, report=False)[2]
        h = held.setdefault(key, {**label, "kernel": key, "calls_held": 0, "max_abs_err": 0.0,
                                  "max_err_over_tol": 0.0, "index_mismatches": 0,
                                  "mismatch_gap_over_tol_max": 0.0})
        h["calls_held"] += 1
        for k in ("max_abs_err", "max_err_over_tol", "mismatch_gap_over_tol_max"):
            h[k] = max(h[k], chk[k])
        h["index_mismatches"] += chk["index_mismatches"]
    for h in held.values():
        print(json.dumps(h), flush=True)


def phase_losses(knn, stats):
    """The PFT loss family beyond the default path, at full width, in two
    runs, each with its own launch counts; every KNN call of each run is
    then held against its plain version. Returns the launches per kernel,
    summed over the two runs."""
    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    def run(frames, **model):
        cfg = load_yaml(default_config_path())
        cfg.DEMO.sequence_length = frames
        cfg.DEMO.sequence_length_refinement = 3
        for flag in ("geometric", "smoothness", "depth_regularizer", "auto_masking",
                     "min_reprojection", "three3d_debias"):
            cfg.LOSS[flag] = True
        cfg.LOSS.knn_sort_period = 4
        cfg.LOSS.three3d_texture_gate = 600.0
        cfg.MODEL.update(model)
        net = cfg.MODEL.depth_network
        runner = keyframe_loop(OnlineAdaptation(cfg))
        for k in knn.KERNELS:
            k.launches = 0
        with Recorder(knn, keep_all=True) as rec:
            r = runner.run(verbose=False)
        launches = launch_counts(knn)
        terms = ("total_loss", "photometric", "geometric", "smoothness", "depth_reg", "three3d")
        line = {"phase": "losses", "network": net, "frames": frames,
                "keyframes": r["num_keyframes"], "mean_abs_rel": r["mean_abs_rel"],
                "map_points": r["map_points"], "regathers": r["regathers"],
                "seeded_keyframes": r["seeded_keyframes"], "steps_per_sec": r["steps_per_sec"],
                "launches": launches, "last": {k: r["metrics"][-1][k] for k in terms}}
        print(json.dumps(line), flush=True)
        bad = [(i, k) for i, m in enumerate(r["metrics"]) for k in terms if not _finite(m[k])]
        if not r["metrics"] or bad:
            fail(f"losses ({net}): non-finite or missing terms {bad[:5]}")
        if not (0.0 < r["mean_abs_rel"] < 0.5):
            fail(f"losses ({net}): mean abs_rel {r['mean_abs_rel']}")
        if r["regathers"] == 0 or r["seeded_keyframes"] == 0:
            fail(f"losses ({net}): the sort cache was not used")
        for key in ("cand", "resident"):
            if launches[key] == 0:
                fail(f"losses ({net}): the run launched no {key} kernel")
        if rec.warm_dense:
            fail(f"losses ({net}): {rec.warm_dense} warm calls took the dense kernel")
        # Every call of the run (regathered maps, cross-keyframe seeds)
        # against its plain version: one line per kernel.
        hold_calls(knn, rec, stats, {"phase": "losses", "network": net})
        return launches

    a = run(12)
    b = run(6, depth_network="monodepth2")
    return {key: a[key] + b[key] for key in a}


# The JAX package's TPU run of the flagship configuration (BENCH_r05.json):
# a sanity band for the port's run, not a target of its speed.
FLAGSHIP_KEYFRAMES = 59
FLAGSHIP_ABS_REL = (0.065, 0.090)
FLAGSHIP_MAP = 3_968_833


@contextlib.contextmanager
def algorithms(deterministic):
    """With ``deterministic``, deterministic algorithms (warnings only) and
    deterministic cuDNN inside the block; the flags are restored after."""
    import torch

    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    if deterministic:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags[:2]
        torch.use_deterministic_algorithms(flags[2], warn_only=flags[3])


def phase_flagship(knn, smi):
    """The flagship configuration (bench.py:67-127 through
    ``profile_adaptation.flagship_config``: index fusion and association,
    the bf16 CNN, the fused Adam), all 60 frames at 320x256, twice after a
    4-frame warm-up: with the default algorithms (the run users get: its
    steps/s, keyframes, map size and KNN launches are checked, its abs_rel
    only reported), then with deterministic algorithms and cuDNN, held to
    every band. With the default algorithms, atomics in cuDNN's backward
    make each run's trajectory differ: 16 runs on an H100 spread mean
    abs_rel over 0.078-0.102, 5 of them past the band's 0.090 (float32 as
    wide; PERF.md §6), so one such run cannot hold the band; the
    deterministic run repeats to the bit. Then fusion's determinism.
    Returns the launches per kernel over both runs and each run's map
    points, mean abs_rel and steps/s."""
    import torch

    from e2eslam_tpu_torch.apps.profile_adaptation import flagship_config
    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    warm = flagship_config(load_yaml(default_config_path()))
    warm.DEMO.sequence_length = 4
    keyframe_loop(OnlineAdaptation(warm)).run(verbose=False)

    def run(deterministic):
        runner = keyframe_loop(OnlineAdaptation(flagship_config(load_yaml(default_config_path()))))
        for k in knn.KERNELS:
            k.launches = 0
        with algorithms(deterministic):
            result = runner.run(verbose=False)
        launches = launch_counts(knn)
        algos = "deterministic" if deterministic else "default"
        print(json.dumps({"phase": "flagship", "algorithms": algos,
                          "keyframes": result["num_keyframes"],
                          "refine_steps": result["refine_steps"],
                          "map_points": result["map_points"],
                          "mean_abs_rel": result["mean_abs_rel"],
                          "elapsed_s": result["elapsed_s"],
                          "steps_per_sec": result["steps_per_sec"], "launches": launches,
                          "abs_rel": [m["abs_rel"] for m in result["metrics"]],
                          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}),
              flush=True)
        losses = [m["total_loss"] for m in result["metrics"]]
        if not result["metrics"] or not all(map(_finite, losses)):
            fail(f"flagship ({algos}): non-finite or missing losses: {losses}")
        if result["num_keyframes"] != FLAGSHIP_KEYFRAMES:
            fail(f"flagship ({algos}): {result['num_keyframes']} keyframes, "
                 f"not {FLAGSHIP_KEYFRAMES}")
        lo, hi = FLAGSHIP_ABS_REL
        if deterministic and not lo <= result["mean_abs_rel"] <= hi:
            fail(f"flagship ({algos}): mean abs_rel {result['mean_abs_rel']:.5f} "
                 f"outside [{lo}, {hi}]")
        if not 0.0 < result["mean_abs_rel"] < 0.5:
            fail(f"flagship ({algos}): mean abs_rel {result['mean_abs_rel']}")
        if abs(result["map_points"] - FLAGSHIP_MAP) > 0.05 * FLAGSHIP_MAP:
            fail(f"flagship ({algos}): {result['map_points']} map points, not within 5% "
                 f"of {FLAGSHIP_MAP}")
        if any(launches.values()):
            fail(f"flagship ({algos}): the index path launched KNN kernels {launches}")
        summary = {"algorithms": algos, "map_points": result["map_points"],
                   "mean_abs_rel": result["mean_abs_rel"],
                   "steps_per_sec": result["steps_per_sec"]}
        return runner, result, launches, summary

    runner, result, a, first = run(False)
    fusion_determinism(runner, result)
    b, second = run(True)[2:]
    return {key: a[key] + b[key] for key in a}, [first, second]


def fusion_determinism(runner, result):
    """Fuse the last keyframe's frame again (its depth from the adapted
    network: nearly every pixel merges, many into shared slots) into two
    copies of the flagship run's final map: the maps and index images must
    be equal byte for byte (duplicate slots resolve by an explicit rule,
    not by the order of the card's writes)."""
    import dataclasses

    import torch

    from e2eslam_tpu_torch.data.pipeline import load_batch
    from e2eslam_tpu_torch.slam.rgbd import build_frame

    colors, depths, K, poses, _ = load_batch(runner.dataset, [0])
    f = result["keyframes"][-1]
    dev = runner.device
    color, gt, K, pose = (torch.from_numpy(x).to(dev)
                          for x in (colors[0][[f]], depths[0][[f]], K[0], poses[0][f]))
    engine = runner.engine
    with torch.no_grad():
        depth = engine.apply_scaling(engine.forward_depths(color)[1], gt, K)
    frame = build_frame(color[0], depth[0], K, pose)
    m = result["map"]
    outs = [runner.engine.slam._update_map(dataclasses.replace(m, data=m.data.clone()), frame)
            for _ in range(2)]
    a, b = outs
    same = {"data": torch.equal(a.data, b.data),
            "index_image": torch.equal(a.index_image, b.index_image),
            "index_image2": torch.equal(a.index_image2, b.index_image2),
            "index_pose": torch.equal(a.index_pose, b.index_pose),
            "count": a.count == b.count, "kf_counter": a.kf_counter == b.kf_counter}
    merged = int((a.index_image >= 0).sum()) - (a.count - m.count)
    print(json.dumps({"phase": "fusion_determinism", "frame": f, "map_points": m.count,
                      "appended": a.count - m.count, "merged_pixels": merged,
                      "same": same}), flush=True)
    if not all(same.values()):
        fail(f"fusion is not deterministic on the card: {same}")

# The JAX package's TPU run of the gradicp row (BENCH_r05.json:19-23): a
# reference line, not a check and not a target.
JAX_GRADICP_ROW = {"ate": 0.071376, "rpe": 0.021508, "abs_rel": 0.0919, "keyframes": 59,
                   "source": "BENCH_r05.json:19-23 (TPU)"}


def trajectory(tag, result, ate_share=None, rpe_max=None):
    """The estimated keyframe poses' checks: rotations orthonormal to 1e-3,
    poses that differ from the dataset's (the odometry ran), finite ATE and
    RPE; with ``ate_share``, ATE under that share of the keyframe
    trajectory's length, and RPE under ``rpe_max`` (tests/test_apps.py:74-102,
    the JAX package's own bar). Returns the trajectory's length."""
    import numpy as np

    est, gt = result["est_poses"], result["gt_kf_poses"]
    R = est[:, :3, :3]
    orth = float(np.abs(np.einsum("nij,nkj->nik", R, R) - np.eye(3)).max())
    moved = float(np.abs(est - gt).max())
    length = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    if not orth < 1e-3:
        fail(f"{tag}: estimated rotations off orthonormal by {orth:.3g}")
    if not moved > 1e-4:
        fail(f"{tag}: the estimated poses equal the dataset's (largest gap {moved:.3g})")
    if not (_finite(result["ate"]) and _finite(result["rpe"])):
        fail(f"{tag}: ATE {result['ate']} or RPE {result['rpe']} not finite")
    if ate_share is not None and not result["ate"] < ate_share * length:
        fail(f"{tag}: ATE {result['ate']:.4f} m is not under {ate_share:.1%} of the "
             f"{length:.3f} m trajectory")
    if rpe_max is not None and not result["rpe"] < rpe_max:
        fail(f"{tag}: RPE {result['rpe']:.4f} is not under {rpe_max}")
    return length


def phase_gradicp(knn, smi):
    """The slice's full-width path: the JAX package's trajectory row
    (bench.py:161-176, ``profile_adaptation.gradicp_config``: the flagship
    with gradICP odometry), all 60 frames at 320x256 after a 4-frame
    warm-up, with the default algorithms and then deterministic ones: 59
    keyframes, rigid estimated poses off the dataset's, ATE under 5.4% of
    the keyframe trajectory and RPE under 0.10, mean abs_rel in (0, 0.5),
    no KNN launch. Returns the launches per kernel over both runs."""
    import torch

    from e2eslam_tpu_torch.apps.profile_adaptation import gradicp_config
    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    warm = gradicp_config(load_yaml(default_config_path()))
    warm.DEMO.sequence_length = 4
    keyframe_loop(OnlineAdaptation(warm)).run(verbose=False)
    print(json.dumps({"phase": "gradicp", "reference": JAX_GRADICP_ROW}), flush=True)
    total = dict.fromkeys(KERNEL_INFO, 0)
    for deterministic in (False, True):
        runner = keyframe_loop(OnlineAdaptation(gradicp_config(load_yaml(default_config_path()))))
        for k in knn.KERNELS:
            k.launches = 0
        with algorithms(deterministic):
            result = runner.run(verbose=False)
        launches = launch_counts(knn)
        algos = "deterministic" if deterministic else "default"
        tag = f"gradicp ({algos})"
        length = trajectory(tag, result, ate_share=0.054, rpe_max=0.10)
        print(json.dumps({"phase": "gradicp", "algorithms": algos,
                          "keyframes": result["num_keyframes"],
                          "refine_steps": result["refine_steps"],
                          "steps_per_sec": result["steps_per_sec"],
                          "elapsed_s": result["elapsed_s"], "ate": result["ate"],
                          "rpe": result["rpe"], "trajectory_m": length,
                          "ate_share": result["ate"] / length,
                          "mean_abs_rel": result["mean_abs_rel"],
                          "map_points": result["map_points"], "launches": launches,
                          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}),
              flush=True)
        losses = [m["total_loss"] for m in result["metrics"]]
        if not result["metrics"] or not all(map(_finite, losses)):
            fail(f"{tag}: non-finite or missing losses: {losses}")
        if result["num_keyframes"] != FLAGSHIP_KEYFRAMES:
            fail(f"{tag}: {result['num_keyframes']} keyframes, not {FLAGSHIP_KEYFRAMES}")
        if not 0.0 < result["mean_abs_rel"] < 0.5:
            fail(f"{tag}: mean abs_rel {result['mean_abs_rel']}")
        if any(launches.values()):
            fail(f"{tag}: the index path launched KNN kernels {launches}")
        total = {key: total[key] + launches[key] for key in total}
    return total


def _default_run(knn, stats, phase, frames, label, *, knn_path, **settings):
    """``frames`` frames of configs/config.yaml with ``settings`` (a dict
    of ``SECTION.key``: value) at full width, its launches counted apart:
    finite loss terms, mean abs_rel in (0, 0.5). With ``knn_path`` the run
    must launch the resident and candidate kernels and no warm dense call,
    and every KNN call it made is held against its plain version; without,
    it must launch none. Returns (result, launches, runner)."""
    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    cfg = load_yaml(default_config_path())
    cfg.DEMO.sequence_length = frames
    for key, value in settings.items():
        section, flag = key.split(".")
        cfg[section][flag] = value
    runner = keyframe_loop(OnlineAdaptation(cfg))
    for k in knn.KERNELS:
        k.launches = 0
    with Recorder(knn, keep_all=True) as rec:
        result = runner.run(verbose=False)
    launches = launch_counts(knn)
    tag = f"{phase} ({' '.join(str(v) for v in label.values())})"
    terms = [k for k in ("total_loss", "photometric", "three3d", "chamfer")
             if k in result["metrics"][-1]]
    bad = [(i, k) for i, m in enumerate(result["metrics"]) for k in terms if not _finite(m[k])]
    if not result["metrics"] or bad:
        fail(f"{tag}: non-finite or missing terms {bad[:5]}")
    if not 0.0 < result["mean_abs_rel"] < 0.5:
        fail(f"{tag}: mean abs_rel {result['mean_abs_rel']}")
    if knn_path:
        for key in ("cand", "resident"):
            if launches[key] == 0:
                fail(f"{tag}: the run launched no {key} kernel")
        if rec.warm_dense:
            fail(f"{tag}: {rec.warm_dense} warm calls took the dense kernel")
    elif any(launches.values()):
        fail(f"{tag}: the path launched KNN kernels {launches}")
    line = {"phase": phase, **label, "frames": frames, "keyframes": result["num_keyframes"],
            "mean_abs_rel": result["mean_abs_rel"], "map_points": result["map_points"],
            "steps_per_sec": result["steps_per_sec"], "ate": result["ate"],
            "rpe": result["rpe"], "launches": launches,
            "last": {k: result["metrics"][-1][k] for k in terms}}
    print(json.dumps(line), flush=True)
    if knn_path:
        hold_calls(knn, rec, stats, {"phase": phase, **label})
    return result, launches, runner


def _add(a, b):
    return {key: a[key] + b[key] for key in a}


def phase_odom_brute(knn, stats):
    """configs/config.yaml with gradICP odometry, 12 frames, the brute
    three3d loss: each keyframe is fused at its estimated pose, so the map
    the resident (tail seed) and candidate (warm) kernels search is
    misregistered by the odometry. Once with ``LOSS.three3d_debias`` and
    once without; ATE and RPE reported, every KNN call held against its
    plain version. Returns the launches per kernel over both runs."""
    total = dict.fromkeys(KERNEL_INFO, 0)
    for debias in (True, False):
        result, launches, _ = _default_run(
            knn, stats, "odom_brute", 12, {"debias": debias}, knn_path=True,
            **{"MODEL.odom": "gradicp", "LOSS.three3d_debias": debias})
        trajectory(f"odom_brute (debias {debias})", result)
        total = _add(total, launches)
    return total


# _source_transform's pose on the card against the CPU's on the same
# frozen inputs, the largest entry gap over the run's 5 keyframe windows:
# twice the widest seen on an H100 (2.46e-4; the gaps repeat from call to
# call: the projective association rounds K.p/z, and a last-bit difference
# between the card's and the CPU's float32 moves a pixel; PERF.md §6).
EST_POSE_TOL = 5e-4


def phase_est_pose(knn, stats):
    """configs/config.yaml with ``DATA.use_gt_pose: false`` and gradICP
    odometry, 6 frames: view synthesis through 20 Levenberg-Marquardt
    iterations inside every PFT step, the photometric gradient flowing
    back through them into the network. Finite losses and finite
    gradients on every step, mean abs_rel in (0, 0.5); the three3d loss is
    the brute one, so its KNN calls are held against their plain versions.
    First ``_source_transform`` on each keyframe window with the seeded
    network's depths, card against CPU (``EST_POSE_TOL``). Returns the
    launches per kernel."""
    import torch
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.data.pipeline import load_batch
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation, keyframe_schedule
    from e2eslam_tpu_torch.engine.refine import PairBatch, RefinementEngine

    settings = {"DATA.use_gt_pose": False, "MODEL.odom": "gradicp"}
    frames = 6
    cfg = load_yaml(default_config_path())
    cfg.DEMO.sequence_length = frames
    for key, value in settings.items():
        section, flag = key.split(".")
        cfg[section][flag] = value
    # The frozen inputs: each keyframe window, the seeded network's depths.
    probe = keyframe_loop(OnlineAdaptation(cfg))
    eng = probe.engine
    colors, gt, K, poses, _ = load_batch(probe.dataset, [0])
    gaps = []
    for prev, frame in keyframe_schedule(poses[0], float(cfg.DEMO.frame_threshold)):
        pair = PairBatch(*(torch.from_numpy(x) for x in (
            colors[0][[prev, frame]], gt[0][[prev, frame]], K[0], poses[0][[prev, frame]])))
        with torch.no_grad():
            dev_pair = PairBatch(*(t.to(eng.device) for t in pair))
            depth = eng.apply_scaling(eng.forward_depths(dev_pair.colors)[1],
                                      dev_pair.gt_depths, dev_pair.intrinsics)
            T_card = eng._source_transform(dev_pair, depth, 0).cpu()
            T_cpu = RefinementEngine._source_transform(eng, pair, depth.cpu(), 0)
        gaps.append(float((T_card - T_cpu).abs().max()))
    print(json.dumps({"phase": "est_pose", "check": "_source_transform card vs cpu",
                      "windows": len(gaps), "max_abs_gap": gaps, "tol": EST_POSE_TOL}),
          flush=True)
    if not max(gaps) <= EST_POSE_TOL:
        fail(f"est_pose: _source_transform on the card differs from the CPU's by {max(gaps):.3g}")
    del probe, eng

    # Every step's gradients: one device flag a step (a global optimizer
    # pre-hook), read after the run.
    flags = []

    def check(opt, args, kwargs):
        grads = [p.grad for g in opt.param_groups for p in g["params"] if p.grad is not None]
        flags.append(torch.stack([torch.isfinite(g).all() for g in grads]).all())

    hook = register_optimizer_step_pre_hook(check)
    try:
        result, launches, _ = _default_run(knn, stats, "est_pose", frames,
                                           {"odom": "gradicp"}, knn_path=True, **settings)
    finally:
        hook.remove()
    if len(flags) != result["refine_steps"] or not bool(torch.stack(flags).all()):
        fail(f"est_pose: non-finite gradients in {len(flags)} steps "
             f"({result['refine_steps']} run)")
    print(json.dumps({"phase": "est_pose", "steps_with_finite_gradients": len(flags)}),
          flush=True)
    return launches


def phase_assoc(knn, stats):
    """The other 3D-loss associations, 12 frames each of configs/config.yaml
    at full width: ``LOSS.knn_impl: projective``, ``voxel`` (the share of
    queries the voxel hash found a neighbour for is reported), and scatter
    fusion within ``MODEL.active_window: 200000`` with the brute loss, whose
    KNN calls are held against their plain versions. Returns the launches
    per kernel over the three runs."""
    import torch

    from e2eslam_tpu_torch.engine import refine

    found = []
    orig = refine.voxel_knn

    def recorded(*a, **kw):
        out = orig(*a, **kw)
        found.append(out[2].float().mean())
        return out

    total = dict.fromkeys(KERNEL_INFO, 0)
    for impl in ("projective", "voxel"):
        refine.voxel_knn = recorded
        try:
            _, launches, runner = _default_run(knn, stats, "assoc", 12, {"knn_impl": impl},
                                               knn_path=False, **{"LOSS.knn_impl": impl})
        finally:
            refine.voxel_knn = orig
        total = _add(total, launches)
    # The first keyframe's steps search the empty map.
    share = torch.stack(found[runner.engine.refinement_steps:])
    if not share.numel():
        fail("assoc (voxel): no voxel search of a non-empty map ran")
    print(json.dumps({"phase": "assoc", "knn_impl": "voxel", "searches": share.numel(),
                      "found_share_mean": float(share.mean()),
                      "found_share_min": float(share.min())}), flush=True)
    _, launches, _ = _default_run(knn, stats, "assoc", 12, {"active_window": 200000},
                                  knn_path=True, **{"MODEL.active_window": 200000})
    return _add(total, launches)


def phase_icl(knn, stats, smi):
    """The reference's ICL-NUIM online configuration
    (configs/config_icl_online.yaml through ``profile_adaptation.icl_config``:
    ResNet-18 indoor at 320x256, brute three3d, PNGs decoded from disk) on
    the repository's 10-frame sequence, its network loaded through
    ``MODEL.use_pretrained_models`` from a ``depth.pth.tar`` of seeded
    weights written to a temporary directory, the adapted network saved
    through ``MODEL.save_checkpoint``. Checks: finite metrics, ATE under
    1e-5 (gt odometry), the candidate and resident kernels launched and
    every KNN call held against its plain version; then a fresh runner that
    restores the checkpoint holds a bit-equal state dict and gives the same
    disparity under deterministic algorithms. Returns the launches."""
    import tempfile

    import torch

    from e2eslam_tpu_torch.apps.profile_adaptation import icl_config, seeded_weights_dir
    from e2eslam_tpu_torch.data import native_loader
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    with tempfile.TemporaryDirectory() as tmp:
        weights = seeded_weights_dir(icl_config(), os.path.join(tmp, "indoor"))
        cfg = icl_config(weights)
        cfg.MODEL.save_checkpoint = os.path.join(tmp, "adapted")
        runner = keyframe_loop(OnlineAdaptation(cfg))
        print(json.dumps({"phase": "icl", "decoder": runner.dataset.decoder,
                          "native_loader": native_loader.unavailable_reason() or "built",
                          "frames": len(runner.dataset.rgb_files),
                          "intrinsics": runner.dataset.intrinsics[:3, :3].tolist()}), flush=True)
        for k in knn.KERNELS:
            k.launches = 0
        with Recorder(knn, keep_all=True) as rec:
            result = runner.run(verbose=False)
        launches = launch_counts(knn)
        terms = ("total_loss", "photometric", "three3d", "abs_rel")
        line = {"phase": "icl", "keyframes": result["num_keyframes"],
                "refine_steps": result["refine_steps"], "elapsed_s": result["elapsed_s"],
                "steps_per_sec": result["steps_per_sec"], "mean_abs_rel": result["mean_abs_rel"],
                "map_points": result["map_points"], "ate": result["ate"], "rpe": result["rpe"],
                "launches": launches, "device": torch.cuda.get_device_name(0),
                "nvidia_smi": smi}
        print(json.dumps(line), flush=True)
        bad = [(i, k) for i, m in enumerate(result["metrics"]) for k in terms if not _finite(m[k])]
        if not result["metrics"] or bad:
            fail(f"icl: non-finite or missing terms {bad[:5]}")
        if not result["ate"] < 1e-5:
            fail(f"icl: ATE {result['ate']} with gt odometry is not under 1e-5")
        for key in ("cand", "resident"):
            if launches[key] == 0:
                fail(f"icl: the run launched no {key} kernel")
        if rec.warm_dense:
            fail(f"icl: {rec.warm_dense} warm calls took the dense kernel")
        hold_calls(knn, rec, stats, {"phase": "icl"})

        restored = icl_config(weights)
        restored.MODEL.restore_checkpoint = cfg.MODEL.save_checkpoint
        fresh = keyframe_loop(OnlineAdaptation(restored))
        a, b = runner.engine.model.state_dict(), fresh.engine.model.state_dict()
        same_state = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        x = torch.from_numpy(runner.dataset[0][0][:2] / 255.0).float().to(runner.device)
        with algorithms(True), torch.no_grad():
            same_disp = torch.equal(runner.engine.forward_depths(x)[0],
                                    fresh.engine.forward_depths(x)[0])
        print(json.dumps({"phase": "icl", "check": "checkpoint restored in a fresh runner",
                          "state_dict_equal": same_state, "disparity_equal": same_disp}),
              flush=True)
        if not (same_state and same_disp):
            fail("icl: the restored checkpoint differs from the adapted network")
    return launches


# The card's projective pass against the CPU's on a copy of the same map:
# K.p/z rounds to another pixel now and then, so the counts may part by a
# few rows (1 and 2 of ~800,000 on an H100, PERF.md §6); held to this share
# of the CPU's count.
PROJ_COUNT_TOL = 1e-3


class CompactionProbe:
    """Wraps ``RefinementEngine.compact_now`` and the end-of-run
    ``compact_map`` of ``engine.adaptation``: each pass is timed with CUDA
    events (the card's only), and the first live pass and the end-of-run
    pass are run again on the CPU on a copy of their input map."""

    def __init__(self):
        self.times_ms, self.checks = [], []

    def __enter__(self):
        import torch

        from e2eslam_tpu_torch.engine import adaptation
        from e2eslam_tpu_torch.engine.refine import RefinementEngine

        self._orig = (RefinementEngine.compact_now, adaptation.compact_map)
        orig_now, orig_map = self._orig
        probe = self

        def timed_call(fn, *a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            out = fn(*a, **kw)
            end.record()
            torch.cuda.synchronize()
            probe.times_ms.append(start.elapsed_time(end))
            return out

        def now(engine, m, pose, K, bucket=None):
            first = not probe.checks
            cpu_in = _map_to("cpu", m) if first else None
            out = timed_call(orig_now, engine, m, pose, K, bucket=bucket)
            if first:
                ref = orig_now(engine, cpu_in, pose.cpu(), K.cpu(), bucket=bucket)
                probe.record("live", cpu_in.count, out, ref)
            return out

        def end_of_run(m, **kw):
            cpu_in = _map_to("cpu", m)
            out = timed_call(orig_map, m, **kw)
            probe.record("end", cpu_in.count, out, orig_map(cpu_in, **kw))
            return out

        RefinementEngine.compact_now = now
        adaptation.compact_map = end_of_run
        return self

    def record(self, kind, before, card, cpu):
        """One pass's card and CPU results, read now (later fusions replace
        the index images): counts, and whether each index image is
        consistent with its count."""
        self.checks.append({"pass": kind, "before": before, "card": card.count,
                            "cpu": cpu.count, "card_index_ok": _index_consistent(card),
                            "cpu_index_ok": _index_consistent(cpu)})

    def __exit__(self, *exc):
        from e2eslam_tpu_torch.engine import adaptation
        from e2eslam_tpu_torch.engine.refine import RefinementEngine

        RefinementEngine.compact_now, adaptation.compact_map = self._orig


def _map_to(device, m):
    import dataclasses

    def move(t):
        return None if t is None else t.to(device, copy=True)

    return dataclasses.replace(m, data=move(m.data), index_image=move(m.index_image),
                               index_pose=move(m.index_pose), index_image2=move(m.index_image2),
                               index_pose2=move(m.index_pose2))


def _index_consistent(m) -> bool:
    """Every cached slot of both index levels is -1 or a valid row."""
    for img in (m.index_image, m.index_image2):
        if img is not None and not bool(((img >= -1) & (img < m.count)).all()):
            return False
    return True


def phase_compact(knn, stats, smi, flagship):
    """Live-map compaction, two runs. (a) The ``compact`` workload
    (tools/bench_flagship_compact.py: the flagship with a projective pass
    after every 10th keyframe), all 60 frames at 320x256: 59 keyframes, no
    KNN launch, the count falling at each of the 5 passes; the first pass
    run again on the CPU on a copy of its map: counts within
    ``PROJ_COUNT_TOL``, both results' index images consistent (every slot
    -1 or below the count). Its map points and mean abs_rel are printed
    beside the flagship run's of the same call (``flagship``), with each
    pass's CUDA-event time. (b) configs/config.yaml, 12 frames, a voxel pass
    every 4th keyframe, a sort period of 3 (so regathers and cross-keyframe
    seeds run) and ``MODEL.compact_voxel: 0.01`` at the end: the keyframe
    after each pass sorts afresh and takes no seeds, every KNN call is held
    against its plain version, the compacted map is smaller, and the voxel
    passes give equal counts on the card and the CPU. Returns the launches
    per kernel over both runs."""
    import torch

    from e2eslam_tpu_torch.apps.profile_adaptation import compact_config
    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    runner = keyframe_loop(OnlineAdaptation(compact_config(load_yaml(default_config_path()))))
    for k in knn.KERNELS:
        k.launches = 0
    with CompactionProbe() as probe:
        result = runner.run(verbose=False)
    launches = launch_counts(knn)
    first = probe.checks[0]
    gap = abs(first["card"] - first["cpu"])
    line = {"phase": "compact", "run": "flagship, projective every 10th keyframe",
            "keyframes": result["num_keyframes"], "steps_per_sec": result["steps_per_sec"],
            "elapsed_s": result["elapsed_s"], "map_points": result["map_points"],
            "mean_abs_rel": result["mean_abs_rel"], "compactions": result["compactions"],
            "pass_ms": probe.times_ms, "launches": launches,
            "flagship_same_call": flagship,
            "first_pass_card_vs_cpu": {**first, "gap": gap, "tol": PROJ_COUNT_TOL},
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print(json.dumps(line), flush=True)
    if result["num_keyframes"] != FLAGSHIP_KEYFRAMES:
        fail(f"compact: {result['num_keyframes']} keyframes, not {FLAGSHIP_KEYFRAMES}")
    if any(launches.values()):
        fail(f"compact: the index path launched KNN kernels {launches}")
    events = result["compactions"]
    if len(events) != FLAGSHIP_KEYFRAMES // 10 or not all(e["after"] < e["before"] for e in events):
        fail(f"compact: the passes did not each shrink the map: {events}")
    if not all(map(_finite, [m["total_loss"] for m in result["metrics"]])):
        fail("compact: non-finite losses")
    if gap > PROJ_COUNT_TOL * first["cpu"]:
        fail(f"compact: the card's projective pass kept {first['card']} rows, the CPU's "
             f"{first['cpu']}")
    if not (first["card_index_ok"] and first["cpu_index_ok"]
            and _index_consistent(result["map"])):
        fail("compact: an index image points past the compacted map")
    a = launches

    cfg = load_yaml(default_config_path())
    cfg.DEMO.sequence_length = 12
    cfg.MODEL.compact_period = 4
    cfg.MODEL.compact_mode = "voxel"
    cfg.MODEL.compact_voxel = 0.01
    cfg.LOSS.knn_sort_period = 3
    runner = keyframe_loop(OnlineAdaptation(cfg))
    for k in knn.KERNELS:
        k.launches = 0
    with CompactionProbe() as probe, Recorder(knn, keep_all=True) as rec:
        result = runner.run(verbose=False)
    b = launch_counts(knn)
    print(json.dumps({"phase": "compact", "run": "config.yaml, voxel every 4th keyframe",
                      "keyframes": result["num_keyframes"],
                      "steps_per_sec": result["steps_per_sec"],
                      "map_points": result["map_points"],
                      "map_points_compacted": result.get("map_points_compacted"),
                      "compactions": result["compactions"], "sorted_at": result["sorted_at"],
                      "seeded_at": result["seeded_at"], "pass_ms": probe.times_ms,
                      "card_vs_cpu": probe.checks, "launches": b}), flush=True)
    for e in result["compactions"]:
        nxt = e["keyframe"] + 1
        if nxt < result["num_keyframes"] and (nxt not in result["sorted_at"]
                                              or nxt in result["seeded_at"]):
            fail(f"compact: keyframe {nxt}, after a pass, reused the sort or the seeds")
    if not result["seeded_at"] or not result["compactions"]:
        fail("compact: no seeded keyframe or no pass ran")
    if not result.get("map_points_compacted", result["map_points"]) < result["map_points"]:
        fail("compact: the end-of-run pass did not shrink the map")
    if len(probe.checks) != 2 or any(c["card"] != c["cpu"] or not c["card_index_ok"]
                                     for c in probe.checks):
        fail(f"compact: the voxel passes on the card and the CPU differ: {probe.checks}")
    for key in ("cand", "resident"):
        if b[key] == 0:
            fail(f"compact: the brute run launched no {key} kernel")
    if rec.warm_dense:
        fail(f"compact: {rec.warm_dense} warm calls took the dense kernel")
    hold_calls(knn, rec, stats, {"phase": "compact"})
    return _add(a, b)


def _finite(x) -> bool:
    return x == x and abs(x) != float("inf")


def _small_loss(**loss):
    def setup(cfg):
        cfg.LOSS.update(loss)
        return cfg
    return setup


def _small_index(cfg):
    """Index fusion and association in float32."""
    cfg.LOSS.three3d_loss = True
    cfg.MODEL.fusion_impl = "index"
    cfg.LOSS.knn_impl = "index"
    return cfg


def _small_flagship(cfg):
    """The flagship settings (bf16 CNN, fused Adam) at 64x64, 6 frames."""
    from e2eslam_tpu_torch.apps.profile_adaptation import flagship_config

    cfg = flagship_config(cfg)
    cfg.DATA.height, cfg.DATA.width = 64, 64
    cfg.DEMO.sequence_length = 6
    return cfg


# Tolerances of the card's runs against the CPU's: the deterministic card
# run's first keyframe (``first``) and later ones (``later``) in abs_rel;
# the default-algorithm run's mean abs_rel (``mean``); both runs' map sizes
# (``map``, relative, at least 4 points).
F32_TOL = {"first": 1e-3, "later": 5e-2, "mean": 5e-2, "map": 1e-2}
# bf16 (cuDNN on the card, oneDNN on the CPU) and the fused Adam against the
# CPU's foreach Adam: twice the widest gaps over 20 repeated runs on an H100
# (``python3 chip_smoke.py --small-repeats 10 flagship``, twice: 0.89%,
# 4.24%, 1.94%, 0.70%; PERF.md §6).
BF16_TOL = {"first": 0.018, "later": 0.085, "mean": 0.039, "map": 0.014}
def _small_gradicp(cfg):
    """The default path with gradICP odometry (the odom_brute path)."""
    cfg.MODEL.odom = "gradicp"
    return cfg


# gradICP odometry and the voxel association against the CPU: twice the
# widest gaps over 20 card runs on an H100 (``python3 chip_smoke.py
# --small-repeats 10 gradicp voxel``, twice: gradicp 7.6e-7, 1.09e-5,
# 0.30%, 0.38%; voxel 7.6e-7, 2.0e-6, 1.6e-5, 0; PERF.md §6). A map
# tolerance of 0 leaves the check's floor of 4 points.
GRADICP_TOL = {"first": 1.6e-6, "later": 2.2e-5, "mean": 0.0061, "map": 0.0076}
VOXEL_TOL = {"first": 1.6e-6, "later": 4e-6, "mean": 3.3e-5, "map": 0.0}
def _small_icl(cfg):
    """The ICL configuration on the repository's sequence at the small size
    (PNGs decoded from disk, resized), from the seeded weights."""
    from e2eslam_tpu_torch.apps.profile_adaptation import icl_config

    icl = icl_config()
    icl.MODEL.use_pretrained_models = False
    icl.DATA.height, icl.DATA.width = cfg.DATA.height, cfg.DATA.width
    icl.DEMO.sequence_length = cfg.DEMO.sequence_length
    icl.DEMO.frame_threshold = cfg.DEMO.frame_threshold
    return icl


def _small_compact(cfg):
    """The compact workload at the small size: the flagship settings with a
    projective pass after every 2nd keyframe."""
    cfg = _small_flagship(cfg)
    cfg.MODEL.compact_period = 2
    cfg.MODEL.compact_mode = "projective"
    return cfg


# The ICL sequence (float32) and the compact workload (bf16, fused Adam,
# projective passes) against the CPU: twice the widest gaps over 20 card
# runs on an H100 (``python3 chip_smoke.py --small-repeats 20 icl
# compact``: icl 1.05e-7, 0.0087, 0.0091, 0.0046; compact 0.0089, 0.0462,
# 0.0115, 0.0093; PERF.md §6).
ICL_TOL = {"first": 2.1e-7, "later": 0.0175, "mean": 0.0181, "map": 0.0092}
COMPACT_TOL = {"first": 0.0177, "later": 0.0924, "mean": 0.023, "map": 0.0187}
SMALL_CONFIGS = {
    "default": (_small_loss(), F32_TOL),
    "chamfer": (_small_loss(three3d_loss=False, chamfer_distance=True), F32_TOL),
    "index": (_small_index, F32_TOL),
    "flagship": (_small_flagship, BF16_TOL),
    "gradicp": (_small_gradicp, GRADICP_TOL),
    "voxel": (_small_loss(knn_impl="voxel"), VOXEL_TOL),
    "icl": (_small_icl, ICL_TOL),
    "compact": (_small_compact, COMPACT_TOL),
}


def phase_small(name, check=True):
    """A path at 64x64: card (kernels, cuDNN) vs CPU (plain versions).
    Returns the gaps the tolerances hold; with ``check`` off it only
    measures them."""
    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    setup, tol = SMALL_CONFIGS[name]

    def run(device):
        cfg = load_yaml(default_config_path())
        cfg.DATA.height, cfg.DATA.width = 64, 64
        cfg.DEMO.sequence_length = 5
        cfg.DEMO.frame_threshold = 0.01
        return keyframe_loop(OnlineAdaptation(setup(cfg), device=device)).run(verbose=False)

    # One card run with deterministic algorithms (restored after), held to
    # the CPU keyframe by keyframe; with the default ones, atomics in the
    # convolutions' backward and the fusion's scatters make the card's
    # trajectory vary from run to run (mean abs_rel 0.0715-0.0735 over 30
    # runs on an H100 against the CPU's 0.0733), now and then past the 5%
    # bound below at the last keyframe.
    with algorithms(True):
        a = run("cuda")
    d = run("cuda")  # the default algorithms, as the main path runs
    b = run("cpu")

    def rel(x, y):
        return abs(x - y) / abs(y)

    gaps = {"first": rel(a["metrics"][0]["abs_rel"], b["metrics"][0]["abs_rel"]),
            "later": max([rel(ma["abs_rel"], mb["abs_rel"])
                          for ma, mb in zip(a["metrics"][1:], b["metrics"][1:])] or [0.0]),
            "mean": rel(d["mean_abs_rel"], b["mean_abs_rel"]),
            "map": max(rel(a["map_points"], b["map_points"]),
                       rel(d["map_points"], b["map_points"]))}
    line = {"phase": "small", "config": name, "runs": ["cuda deterministic", "cuda default", "cpu"],
            "keyframes": [a["num_keyframes"], d["num_keyframes"], b["num_keyframes"]],
            "mean_abs_rel": [a["mean_abs_rel"], d["mean_abs_rel"], b["mean_abs_rel"]],
            "map_points": [a["map_points"], d["map_points"], b["map_points"]],
            "gaps": gaps, "tolerances": tol}
    print(json.dumps(line), flush=True)
    if not check:
        return gaps
    if not a["keyframes"] == d["keyframes"] == b["keyframes"]:
        fail(f"small ({name}): card and CPU chose different keyframes")
    # float32: the default run's mean abs_rel to 5%, twice the widest gap to
    # the CPU over those 30 runs (2.4%); the deterministic run keyframe by
    # keyframe as tests/test_torch_engine.py holds the port to the JAX
    # package (the first keyframe, an empty map, to 1e-3; later ones to 5%,
    # as nearest-neighbour near-ties flip a few neighbours and Adam's
    # normalised steps spread that); the map sizes to 1%.
    for key, gap in gaps.items():
        if key == "map":
            ok = max(abs(a["map_points"] - b["map_points"]),
                     abs(d["map_points"] - b["map_points"])) <= max(4, tol["map"] * b["map_points"])
        else:
            ok = gap <= tol[key]
        if not ok:
            fail(f"small ({name}): the card's {key} gap to the CPU {gap:.4g} exceeds {tol[key]}")
    return gaps


# --- the offline apps (train_depth, OFT, SCALE, the scaling tools, the
# gradient-flow recovery, the demo) -------------------------------------------

OUT_DIR = os.path.join(ROOT, "chip_smoke_out")  # git-ignored; emptied at the end
# OFT's window and a loop of its steps, on the card: tests/test_torch_oft_scale.py's
# float32 tolerance (rtol 1e-4, or DEPTH_ATOL for a pixel whose gradient is
# of Adam's eps's order).
OFT_RTOL, OFT_ATOL = 1e-4, 5.3e-5


def _offline_config(path, weights):
    """An offline app's published configuration (configs/config_train_depth_icl.yaml
    or configs/config_scale_learning.yaml) on the repository's ICL sequence,
    its network loaded from ``weights`` (a depth.pth.tar of seeded
    weights). Cut: DATA.start 418 -> 0 (the sequence has 10 frames) and the
    weights; kept: frames [0, -1], dilation 2 and stride 2 (4 windows),
    25 refinement steps, the losses, the scaling, the optimizer."""
    from e2eslam_tpu_torch.apps.profile_adaptation import MINI_ICL_ROOT
    from e2eslam_tpu_torch.config import load_yaml

    cfg = load_yaml(os.path.join(ROOT, "configs", path))
    cfg.DATA.data_path = MINI_ICL_ROOT
    cfg.DATA.start = 0
    cfg.MODEL.use_pretrained_models = True
    cfg.MODEL.load_depth_path = weights
    cfg.DEBUG.print_metrics = False
    cfg.DEBUG.plot = False
    cfg.DEBUG.plot_path = None  # no matplotlib on the card's machine: no PNG
    return cfg


def _weights():
    from e2eslam_tpu_torch.apps.profile_adaptation import icl_config, seeded_weights_dir

    path = os.path.join(OUT_DIR, "indoor")
    if not os.path.exists(os.path.join(path, "depth.pth.tar")):
        seeded_weights_dir(icl_config(), path)
    return path


def _reset(knn):
    for k in knn.KERNELS:
        k.launches = 0


def _need_kernels(phase, launches, rec, keys=("cand", "resident")):
    for key in keys:
        if launches[key] == 0:
            fail(f"{phase}: the run launched no {key} kernel")
    if rec.warm_dense:
        fail(f"{phase}: {rec.warm_dense} warm calls took the dense kernel")


def phase_train_depth(knn, stats, smi):
    """apps/train_depth on configs/config_train_depth_icl.yaml (320x256,
    ResNet-18 indoor, three3d brute against each window's 163,840-row
    ground-truth reconstruction, smoothness, constant scaling 6.9, Adam 1e-5,
    25 steps a window) over the repository's ICL sequence: every KNN call
    held against its plain version; the last window's last step with
    VIZ.log_gradients and VIZ.grad_images: finite gradient norms for every
    parameter, non-zero for the trainable ones the network runs, the taps'
    gradients of decoder_tap_shapes; the checkpoint saved under
    SETTINGS.log_path restored into a fresh network: equal state dicts."""
    import time as _time

    import torch

    from e2eslam_tpu_torch.apps.train_depth import train
    from e2eslam_tpu_torch.checkpoint import load_checkpoint
    from e2eslam_tpu_torch.models.decoders import decoder_tap_shapes
    from e2eslam_tpu_torch.models.depth_net import make_depth_model

    cfg = _offline_config("config_train_depth_icl.yaml", _weights())
    cfg.SETTINGS.log_path = os.path.join(OUT_DIR, "train_depth")
    cfg.VIZ.log_gradients = True
    cfg.VIZ.grad_images = True
    _reset(knn)
    t0 = _time.perf_counter()
    with Recorder(knn, keep_all=True) as rec:
        out = train(cfg, verbose=False, render=False)
    torch.cuda.synchronize()
    seconds = _time.perf_counter() - t0
    launches = launch_counts(knn)
    for w, (first, last) in enumerate(zip(out["first_metrics"], out["metrics"])):
        print(json.dumps({"phase": "train_depth", "window": w,
                          "abs_rel_first": first["abs_rel"], "abs_rel_last": last["abs_rel"],
                          "loss_first": first["total_loss"], "loss_last": last["total_loss"],
                          "three3d_last": last["three3d"]}), flush=True)
    n_windows = len(out["metrics"])
    print(json.dumps({"phase": "train_depth", "windows": n_windows,
                      "steps": out["global_step"], "seconds": seconds,
                      "loop_s": out["elapsed_s"],
                      "steps_per_sec": out["global_step"] / out["elapsed_s"],
                      "launches": launches,
                      "cuts": {"DATA.start": "418 -> 0", "DATA.data_path": "tests/data",
                               "weights": "seeded depth.pth.tar"},
                      "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    if n_windows < 3 or out["global_step"] != 25 * n_windows:
        fail(f"train_depth: {n_windows} windows, {out['global_step']} steps")
    bad = [(i, k) for i, m in enumerate(out["metrics"] + out["first_metrics"])
           for k in ("total_loss", "abs_rel", "three3d") if not _finite(m[k])]
    if bad or not all(m["three3d"] > 0 for m in out["metrics"]):
        fail(f"train_depth: non-finite or dead terms {bad[:5]}")
    _need_kernels("train_depth", launches, rec)
    hold_calls(knn, rec, stats, {"phase": "train_depth"})
    # Observability of the last step.
    model = out["engine"].model
    norms = out["grad_norms"]
    unused = tuple(f"decoder.{10 + s}." for s in (1, 2, 3))  # heads the indoor net never runs
    trainable = [n for n, p in model.named_parameters()
                 if p.requires_grad and not n.startswith(unused)]
    shapes = decoder_tap_shapes(2, int(cfg.DATA.height), int(cfg.DATA.width))
    tap_shapes = {k: tuple(v.shape) for k, v in out["grad_images"].items()}
    ok_norms = (set(norms) == {n for n, _ in model.named_parameters()}
                and all(map(_finite, norms.values()))
                and all(norms[n] > 0 for n in trainable))
    print(json.dumps({"phase": "train_depth", "check": "observability", "norms": len(norms),
                      "trainable_nonzero": sum(norms[n] > 0 for n in trainable),
                      "trainable": len(trainable), "taps_ok": tap_shapes == shapes,
                      "tap_grad_max": {k: float(v.abs().max())
                                       for k, v in out["grad_images"].items()}}), flush=True)
    if not ok_norms or tap_shapes != shapes:
        fail("train_depth: gradient norms or tap gradients are wrong")
    fresh = make_depth_model(cfg).cuda()
    load_checkpoint(out["checkpoint"], fresh)
    a, b = model.state_dict(), fresh.state_dict()
    same = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    print(json.dumps({"phase": "train_depth", "check": "checkpoint restored",
                      "state_dict_equal": same}), flush=True)
    if not same:
        fail("train_depth: the restored checkpoint differs from the adapted network")
    return launches


def phase_oft(knn, stats, smi):
    """apps/train_depth_oft on the same configuration and windows (25 OFT
    steps a window, a fresh Adam each): every KNN call held against its
    plain version; then on the first window ``oft_window`` and a loop of
    ``oft_step``: the same depths to OFT_RTOL / OFT_ATOL."""
    import time as _time

    import torch

    from e2eslam_tpu_torch.apps.common import window
    from e2eslam_tpu_torch.apps.train_depth import gt_reconstruction
    from e2eslam_tpu_torch.apps.train_depth_oft import train
    from e2eslam_tpu_torch.data.pipeline import make_dataset

    cfg = _offline_config("config_train_depth_icl.yaml", _weights())
    _reset(knn)
    t0 = _time.perf_counter()
    with Recorder(knn, keep_all=True) as rec:
        out = train(cfg, verbose=False)
    torch.cuda.synchronize()
    seconds = _time.perf_counter() - t0
    launches = launch_counts(knn)
    steps = 25 * len(out["metrics"])
    print(json.dumps({"phase": "oft", "windows": len(out["metrics"]), "steps": steps,
                      "seconds": seconds, "loop_s": out["elapsed_s"],
                      "steps_per_sec": steps / out["elapsed_s"],
                      "abs_rel_last": [m["abs_rel"] for m in out["metrics"]],
                      "loss_last": [m["total_loss"] for m in out["metrics"]],
                      "launches": launches, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    if len(out["metrics"]) < 3 or not all(_finite(m["total_loss"]) and m["three3d"] > 0
                                          for m in out["metrics"]):
        fail("oft: missing windows, non-finite or dead losses")
    _need_kernels("oft", launches, rec)
    hold_calls(knn, rec, stats, {"phase": "oft"})
    engine = out["engine"]
    pair = window(make_dataset(cfg, sequence_length=len(cfg.DATA.frames)), 0, engine.device)
    gt_map = gt_reconstruction(cfg, pair, 2 * pair.colors.shape[1] * pair.colors.shape[2])
    fast, _ = engine.oft_window(pair, gt_map)
    _, frozen = engine.predict_depth(pair.colors)
    initial = engine.apply_scaling(frozen, pair.gt_depths, pair.intrinsics)
    oft = engine.oft_state(frozen)
    mi = engine.build_map_index(gt_map)
    for _ in range(engine.refinement_steps):
        engine.oft_step(oft, initial, pair, gt_map, mi)
    gap = (oft.depths.detach() - fast).abs()
    ok = bool((gap <= OFT_ATOL + OFT_RTOL * fast.abs()).all())
    print(json.dumps({"phase": "oft", "check": "oft_window against an oft_step loop",
                      "max_abs_gap": float(gap.max()), "equal": bool(torch.equal(
                          oft.depths.detach(), fast)), "rtol": OFT_RTOL, "atol": OFT_ATOL}),
          flush=True)
    if not ok:
        fail("oft: oft_window and the oft_step loop disagree")
    return launches


# apps/absolute_scale and apps/median_scaling, card against CPU: the widest
# absolute gap of a learned scale and of a bias over the grid, the median
# ratio's relative gap. Twice the widest gaps over 10 card runs on an H100
# (``python3 chip_smoke.py --small-repeats 10 scale scaling_tools``: 2.92e-5,
# 2.70e-5, 1.54e-7; every run gave the same gaps; PERF.md section 6).
SCALE_TOL = {"scale": 5.9e-5, "bias": 5.4e-5, "median": 3.1e-7}
_CPU_RUNS = {}


def phase_scale(knn, smi, check=True):
    """apps/absolute_scale with configs/config_scale_learning.yaml's grid (1,
    3, 5, 6, 7, 9), scale and bias, Adam 1e-3, 25 steps a window over the
    same 4 windows, on the card and on the CPU: no KNN launch; the best
    entry's learned scale and bias card against CPU within SCALE_TOL.
    Returns the gaps."""
    import time as _time

    import torch

    from e2eslam_tpu_torch.apps.absolute_scale import train_scale

    cfg = _offline_config("config_scale_learning.yaml", _weights())
    _reset(knn)
    t0 = _time.perf_counter()
    card = train_scale(cfg, verbose=False)
    torch.cuda.synchronize()
    seconds = _time.perf_counter() - t0
    launches = launch_counts(knn)
    if "scale" not in _CPU_RUNS:  # deterministic: one CPU run serves every repeat
        _CPU_RUNS["scale"] = train_scale(cfg, verbose=False, device="cpu")
    cpu = _CPU_RUNS["scale"]
    gaps = {k: max(abs(a[k] - b[k]) for a, b in zip(card["results"], cpu["results"]))
            for k in ("scale", "bias")}
    print(json.dumps({"phase": "scale", "grid": [e["init"] for e in card["results"]],
                      "card": card["best"], "cpu": cpu["best"], "gaps": gaps,
                      "tolerances": SCALE_TOL, "seconds": seconds, "launches": launches,
                      "nvidia_smi": smi}), flush=True)
    if not check:
        return gaps
    if any(launches.values()):
        fail(f"scale: KNN launches {launches}")
    if not all(_finite(e["final_loss"]) for e in card["results"]):
        fail("scale: non-finite losses")
    for k, gap in gaps.items():
        if gap > SCALE_TOL[k]:
            fail(f"scale: the card's {k} gap to the CPU {gap:.4g} exceeds {SCALE_TOL[k]}")
    return gaps


def phase_scaling_tools(knn, smi, check=True):
    """apps/median_scaling (the ratio, card against CPU, SCALE_TOL["median"]),
    apps/test_depth_scaling (constant scaling 6.9, PFT against an empty map,
    25 steps a window: finite mean abs_rel) and apps/pose_checker (under
    1e-4) on the ICL configuration and sequence. Returns the gaps."""
    import torch

    from e2eslam_tpu_torch.apps.median_scaling import find_median_scale
    from e2eslam_tpu_torch.apps.pose_checker import check as pose_check
    from e2eslam_tpu_torch.apps.test_depth_scaling import evaluate

    cfg = _offline_config("config_train_depth_icl.yaml", _weights())
    if "median" not in _CPU_RUNS:
        _CPU_RUNS["median"] = find_median_scale(cfg, device="cpu")
    card, cpu = find_median_scale(cfg), _CPU_RUNS["median"]
    gaps = {"median": abs(card - cpu) / abs(cpu)}
    _reset(knn)
    ev = evaluate(cfg, verbose=False)
    torch.cuda.synchronize()
    launches = launch_counts(knn)
    err = pose_check(cfg, verbose=False)
    print(json.dumps({"phase": "scaling_tools", "median_scale": [card, cpu], "gaps": gaps,
                      "test_depth_scaling_mean_abs_rel": ev["mean_abs_rel"],
                      "test_depth_scaling_windows": len(ev["metrics"]),
                      "pose_checker_err": err, "launches": launches, "nvidia_smi": smi}),
          flush=True)
    if not check:
        return gaps
    if gaps["median"] > SCALE_TOL["median"]:
        fail(f"scaling_tools: median ratio gap {gaps['median']:.4g}")
    if not _finite(ev["mean_abs_rel"]) or any(launches.values()):
        fail(f"scaling_tools: mean abs_rel {ev['mean_abs_rel']}, launches {launches}")
    if not err < 1e-4:
        fail(f"scaling_tools: pose_checker error {err}")
    return gaps


def phase_recover(knn, stats, smi):
    """apps/gradient_experiments on 2 frames of configs/config.yaml at
    320x256 (DEPTH_RECOVER: depth and colour noise on the last frame, both
    optimised), 20 Adam steps: the loss falls; every KNN call is a cold
    dense-kernel launch (163,840-row buffers, past RES_MAX_ROWS), each held
    against dense_plain, the largest timed (the ``recover cold`` entry)."""
    import time as _time

    import torch

    from e2eslam_tpu_torch.apps.gradient_experiments import recover_image
    from e2eslam_tpu_torch.config import default_config_path, load_yaml

    cfg = load_yaml(default_config_path())
    _reset(knn)
    t0 = _time.perf_counter()
    with Recorder(knn, keep_all=True) as rec:
        out = recover_image(cfg, num_steps=20, verbose=False)
    torch.cuda.synchronize()
    seconds = _time.perf_counter() - t0
    launches = launch_counts(knn)
    print(json.dumps({"phase": "recover", "steps": len(out["history"]),
                      "initial_loss": out["initial_loss"], "final_loss": out["final_loss"],
                      "history": out["history"], "seconds": seconds, "launches": launches,
                      "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    if not out["final_loss"] < out["initial_loss"]:
        fail("recover: the loss did not fall")
    if launches["dense"] != 20 or launches["cand"] or launches["resident"]:
        fail(f"recover: KNN launches {launches}, wanted 20 dense calls alone")
    hold_calls(knn, rec, stats, {"phase": "recover"})
    compare_call(knn, "dense", rec.calls["dense"][1], "recover cold", stats, timing=True,
                 stats_key="dense_recover")
    return launches


def phase_demo(knn, smi):
    """apps/demo on 6 frames of configs/config.yaml (320x256): one host
    snapshot per keyframe, counts that never decrease, the last equal to the
    final map's; the last snapshot's PLY and the animation HTML written to a
    git-ignored directory, the HTML read back with one frame per keyframe."""
    from e2eslam_tpu_torch.apps.demo import Demo
    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.viz.animation import read_animation_html
    from e2eslam_tpu_torch.viz.pointcloud_export import export_ply

    cfg = load_yaml(default_config_path())
    cfg.DEMO.sequence_length = 6
    demo = Demo(cfg)
    _reset(knn)
    result = demo.run(verbose=False)
    launches = launch_counts(knn)
    counts = [s.count for s in result["snapshots"]]
    out_dir = os.path.join(OUT_DIR, "demo")
    ply = export_ply(result["snapshots"][-1], os.path.join(out_dir, "map_last.ply"),
                     max_points=50000)
    html = demo.export_animation(result, os.path.join(out_dir, "map_update.html"),
                                 max_points=20000)
    frames = len(read_animation_html(html)["frames"])
    print(json.dumps({"phase": "demo", "keyframes": result["num_keyframes"],
                      "snapshot_counts": counts, "map_points": result["map_points"],
                      "animation_frames": frames, "ply_bytes": os.path.getsize(ply),
                      "html_bytes": os.path.getsize(html), "launches": launches,
                      "mean_abs_rel": result["mean_abs_rel"], "nvidia_smi": smi}), flush=True)
    if not (len(counts) == result["num_keyframes"] == frames >= 3):
        fail(f"demo: {len(counts)} snapshots, {frames} frames, "
             f"{result['num_keyframes']} keyframes")
    if counts != sorted(counts) or counts[-1] != result["map_points"]:
        fail(f"demo: snapshot counts {counts}, map {result['map_points']}")
    return launches


# --- several sequences at once on the card, and the map-sharded search -----

BATCHED_B, BATCHED_FRAMES = 4, 16
# A batched sequence against its solo run, its first two keyframes' abs_rel
# and its mean: twice the widest gaps of ``--batched-repeats 20`` (default
# algorithms, NVIDIA H100 80GB HBM3 at 700 W: 0.01228 and 0.02117). The grouped
# convolution rounds differently (6e-7 relative on the disparity) and
# Adam's sign-normalised first steps carry that to the abs_rel: with
# deterministic algorithms the batched runs still differ from the solo ones
# by up to 1.3e-3 at the first keyframe and 4.5e-3 at the second.
BATCHED_FIRST_TOL = 0.0246
BATCHED_MEAN_TOL = 0.0424
# One sequence through the batched runner (its network called unbatched)
# against its solo run, deterministic algorithms: the same arithmetic.
BATCHED_ONE_TOL = 1e-6


def _batched_sequences(b=BATCHED_B, frames=BATCHED_FRAMES):
    """``b`` synthetic sequences at 320x256 with staggered starts
    (``profile_adaptation.make_sequences``), the last one frozen after its
    sixth frame (fewer keyframes: ragged schedules); one in-memory dataset
    per sequence and the stacked arrays the batched runner takes, read back
    through the datasets' scaling so both runners see the same values."""
    import numpy as np

    from e2eslam_tpu_torch.apps.profile_adaptation import make_sequences
    from e2eslam_tpu_torch.data.pipeline import ArrayDataset, load_batch

    c, d, K, p = make_sequences(b, frames, 256, 320)
    if b > 1:
        c[-1, 6:], d[-1, 6:], p[-1, 6:] = c[-1, 5], d[-1, 5], p[-1, 5]
    sets = [ArrayDataset(c[i], d[i], K[i], p[i]) for i in range(b)]
    batches = [load_batch(s, [0]) for s in sets]
    return sets, tuple(np.concatenate([x[k] for x in batches]) for k in range(4))


def _batched_cfg(frames=BATCHED_FRAMES):
    from e2eslam_tpu_torch.config import default_config_path, load_yaml

    cfg = load_yaml(default_config_path())  # 320x256, ResNet-18, brute three3d, 3 steps
    cfg.DEMO.sequence_length = frames
    return cfg


def _solo(cfg, dataset, i):
    """Sequence ``i`` alone through ``OnlineAdaptation``, seeded
    ``SETTINGS.seed + i`` as the batched runner seeds it."""
    import copy

    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation
    from e2eslam_tpu_torch.models.depth_net import make_depth_model

    c = copy.deepcopy(cfg)
    c.SETTINGS.seed = 1 + i
    runner = keyframe_loop(OnlineAdaptation(c, dataset=dataset, model=make_depth_model(cfg)))
    return runner.run(verbose=False)


def _gap(par, solo):
    """A batched sequence's result against its solo run's."""
    first = [abs(a - m["abs_rel"]) for a, m in zip(par["per_pair_abs_rel"][:2],
                                                   solo["metrics"][:2])]
    return {"keyframes_equal": par["keyframes"] == solo["keyframes"],
            "first_two": max(first or [0.0]),
            "mean": abs(par["mean_abs_rel"] - solo["mean_abs_rel"]),
            "abs_rel": [round(a, 6) for a in par["per_pair_abs_rel"]],
            "solo_abs_rel": [round(m["abs_rel"], 6) for m in solo["metrics"]]}


def batched_vs_solo(knn, rec=None):
    """The batched runner on BATCHED_B sequences (default algorithms), then
    each sequence alone. Returns (batched line with its launches,
    per-sequence gaps)."""
    from e2eslam_tpu_torch.apps.profile_adaptation import run_batched

    cfg = _batched_cfg()
    sets, seqs = _batched_sequences()
    with rec if rec is not None else contextlib.nullcontext():
        line, out = run_batched(cfg, seqs)
    line["launches"] = launch_counts(knn)
    return line, [_gap(out["per_sequence"][i], _solo(cfg, s, i)) for i, s in enumerate(sets)]


def host_syncs_per_event(cfg, seqs):
    """Host synchronisations of the batched runner per keyframe event: the
    synchronising CUDA calls ``torch.cuda.set_sync_debug_mode`` reports
    over a run, divided by its events."""
    import warnings

    import torch

    from e2eslam_tpu_torch.parallel.adaptation import ParallelAdaptation
    from e2eslam_tpu_torch.models.depth_net import make_depth_model

    b, L, h, w = seqs[0].shape[:4]
    par = ParallelAdaptation(cfg, make_depth_model(cfg), map_capacity=L * h * w, n_seq=b)
    state = par.init_state()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = par.run(state, seqs, threshold=float(cfg.DEMO.frame_threshold))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return syncs / out["num_events"], syncs, out["num_events"]


def phase_batched(knn, stats, smi):
    """BATCHED_B sequences of the default config at full width through the
    batched runner against their solo runs: with deterministic algorithms
    (one sequence through the runner equals its solo run; B = 4 is the same
    whatever the sequences' order), then with the default ones (the main
    path: its launches, the first keyframes' and the mean abs_rel's bands);
    B = 1; the host syncs an event; the flagship settings at B = 4."""
    from e2eslam_tpu_torch.apps.profile_adaptation import (
        flagship_config,
        make_sequences,
        run_batched,
    )
    from e2eslam_tpu_torch.config import default_config_path, load_yaml

    cfg = _batched_cfg()
    sets, seqs = _batched_sequences()
    perm = [2, 3, 0, 1]
    with algorithms(True):
        solos = [_solo(cfg, s, i) for i, s in enumerate(sets)]
        b4 = run_batched(cfg, seqs)[1]["per_sequence"]
        b4p = run_batched(cfg, tuple(x[perm] for x in seqs))[1]["per_sequence"]
        one = {i: run_batched(cfg, tuple(x[i:i + 1] for x in seqs))[1]["per_sequence"][0]
               for i in (0, 2)}
    det = {"phase": "batched", "case": "deterministic",
           "B4": [_gap(b4[i], solos[i]) for i in range(BATCHED_B)],
           "B4_order": perm,
           "B4_reordered_equal": all(b4p[perm.index(i)]["per_pair_abs_rel"]
                                     == b4[i]["per_pair_abs_rel"] for i in range(BATCHED_B)),
           "B1": {i: _gap(r, solos[i]) for i, r in one.items()}}
    print(json.dumps(det), flush=True)
    for i, g in enumerate(det["B4"]):
        if not g["keyframes_equal"]:
            fail(f"batched: sequence {i} chose other keyframes than its solo run")
    if not det["B4_reordered_equal"]:
        fail("batched: a sequence's result depends on its slot in the batch")
    for i, g in det["B1"].items():
        if not g["keyframes_equal"] or g["first_two"] > BATCHED_ONE_TOL:
            fail(f"batched: sequence {i} alone through the runner is {g['first_two']:.3g} "
                 f"off its solo run (tolerance {BATCHED_ONE_TOL})")
    # The main path: the default algorithms, launches counted.
    for k in knn.KERNELS:
        k.launches = 0
    rec = Recorder(knn)
    line, gaps = batched_vs_solo(knn, rec)
    launches = line["launches"]
    print(json.dumps({"phase": "batched", "case": "default", **line, "solo": gaps,
                      "nvidia_smi": smi}), flush=True)
    for key in ("cand", "resident"):
        if launches[key] == 0:
            fail(f"batched: the run launched no {key} kernel")
    if rec.warm_dense:
        fail(f"batched: {rec.warm_dense} warm calls took the dense kernel")
    for i, g in enumerate(gaps):
        if not g["keyframes_equal"]:
            fail(f"batched: sequence {i} chose other keyframes than its solo run")
        if g["first_two"] > BATCHED_FIRST_TOL or g["mean"] > BATCHED_MEAN_TOL:
            fail(f"batched: sequence {i} is {g['first_two']:.3g} (first keyframes) and "
                 f"{g['mean']:.3g} (mean abs_rel) off its solo run (bands "
                 f"{BATCHED_FIRST_TOL}, {BATCHED_MEAN_TOL})")
    if len(set(line["keyframes"])) < 2:
        fail(f"batched: the schedules are not ragged: {line['keyframes']}")
    # The largest call of each kernel on this path, held against its plain
    # version (the main path's phase times the same shapes).
    for key, (_, args) in rec.calls.items():
        compare_call(knn, key, args, "batched", stats, stats_key=f"{key}_batched")

    _, one = _batched_sequences(1)
    b1, _ = run_batched(cfg, one)
    print(json.dumps({"phase": "batched", "case": "B=1", **b1}), flush=True)
    per_event, syncs, events = host_syncs_per_event(
        cfg, tuple(x[:, :6] if x.ndim > 3 else x for x in _batched_sequences()[1]))
    print(json.dumps({"phase": "batched", "case": "host syncs", "B": BATCHED_B,
                      "events": events, "syncs": syncs, "syncs_per_event": per_event}),
          flush=True)

    fcfg = flagship_config(load_yaml(default_config_path()))
    fcfg.DEMO.sequence_length = 12
    fl, res = run_batched(fcfg, make_sequences(4, 12, 256, 320))
    print(json.dumps({"phase": "batched", "case": "flagship B=4", **fl, "nvidia_smi": smi}),
          flush=True)
    bad = [r["mean_abs_rel"] for r in res["per_sequence"]
           if not (_finite(r["mean_abs_rel"]) and 0.0 < r["mean_abs_rel"] < 0.5)]
    if bad or any(fl["launches"].values()):
        fail(f"batched flagship: abs_rel {fl['mean_abs_rel']}, launches {fl['launches']}")
    return launches


def batched_repeats(n, knn):
    """``batched_vs_solo`` ``n`` times, measuring only: the widest gap of
    each kind (the data of BATCHED_FIRST_TOL and BATCHED_MEAN_TOL)."""
    runs = []
    for _ in range(n):
        runs.append(batched_vs_solo(knn)[1])
    widest = {key: max(g[key] for gaps in runs for g in gaps) for key in ("first_two", "mean")}
    print(json.dumps({"phase": "batched_repeats", "runs": n, "widest_gaps": widest,
                      "keyframes_equal": all(g["keyframes_equal"] for gaps in runs
                                             for g in gaps)}), flush=True)


SHARDS, SHARD_ROWS = 4, 655_360  # the map's capacity: 4 shards of 655,360 rows
SHARD_FRAME = 81_920  # one 320x256 frame's points
# The sharded chamfer's value against the unsharded one: the frame->map
# half takes the same rows; the map->frame half sums the shards' parts in
# another order (float32 reassociation over millions of rows). Its frame
# gradient is held by ``chamfer_grad_check``.
SHARDED_RTOL = 1e-5


def chamfer_grad_check(knn, frame, map_pts, n_map, g_s, g_r, picks_s, picks_r):
    """The sharded chamfer's frame gradient ``g_s`` against the unsharded
    ``g_r``. ``picks_*`` are each side's (frame->map, map->frame) nearest
    rows. Where the two sides picked different rows, both picks must be
    float32 ties (``fp32_distance_bound``), and ``g_r`` is moved by those
    rows' terms (a far map row sits nearly as close to several frame
    points, and the shard's search breaks such ties in another order than
    the whole map's). Then each entry, a sum of one frame->map term and of
    the map->frame terms of the rows whose nearest frame point it is,
    accumulated in any order, errs on each side by at most ``(n + 3) u
    sum|t|`` over that side's terms (``n`` terms, ``u = 2^-24``); the two
    sides may differ by the sum of their bounds. Returns the check's
    numbers."""
    import torch

    f, m = frame.double(), map_pts[:n_map].double()
    nq = f.shape[0]
    (ab_s, ba_s), (ab_r, ba_r) = ((a.long(), b[:n_map].long()) for a, b in (picks_s, picks_r))
    ties, worst = 0, 0.0
    g = g_r.double().clone()
    for q, refs, s_, r_, scale in ((f, map_pts.double(), ab_s, ab_r, 2.0 / nq),
                                   (m, f, ba_s, ba_r, 2.0 / n_map)):
        diff = (s_ != r_).nonzero()[:, 0]
        if not diff.numel():
            continue
        qd, a, b = q[diff], refs[s_[diff]], refs[r_[diff]]
        gap = (((qd - a) ** 2).sum(1) - ((qd - b) ** 2).sum(1)).abs()
        tol = torch.maximum(knn.fp32_distance_bound(qd, a), knn.fp32_distance_bound(qd, b))
        ties += int(diff.numel())
        worst = max(worst, float((gap / tol).max()))
        if q is f:  # a frame point's own term: (2 / nq) (f - winner)
            g[diff] += scale * (b - a)
        else:  # a map row's term moves between two frame points
            g.index_add_(0, s_[diff], scale * (a - qd))
            g.index_add_(0, r_[diff], -scale * (b - qd))

    def accumulation(ab, ba):
        terms = torch.zeros_like(f).index_add_(0, ba, (2.0 / n_map) * (f[ba] - m).abs())
        terms += (2.0 / nq) * (f - map_pts[ab].double()).abs()
        n = torch.bincount(ba, minlength=nq).double()[:, None] + 1.0
        return (n + 3.0) * 2.0 ** -24 * terms, n

    # Each side's float32 sum errs by its own bound; a moved term leaves the
    # unsharded sum's rounding behind.
    bound_s, n = accumulation(ab_s, ba_s)
    bound = bound_s + accumulation(ab_r, ba_r)[0]
    err = (g_s.double() - g).abs()
    ratio = err / bound
    at = int(ratio.argmax())
    r, c = at // 3, at % 3
    return {"picks_differing": ties, "tie_gap_over_tol_max": worst,
            "grad_max_abs_err": float((g_s - g_r).abs().max()),
            "grad_max": float(g_r.abs().max()),
            "grad_err_over_bound_max": float(ratio.max()),
            "worst_entry": {"row": r, "terms": int(n[r, 0]), "err": float(err[r, c]),
                            "bound": float(bound[r, c]), "sharded": float(g_s[r, c]),
                            "unsharded": float(g_r[r, c]), "moved": float(g[r, c])}}


def _shard_routes(knn, fn):
    before = launch_counts(knn)
    out = fn()
    after = launch_counts(knn)
    return out, {k: after[k] - before[k] for k in after}


def phase_sharded(knn, stats):
    """The map-sharded exact search and chamfer on one card: SHARDS virtual
    shards (``shard_search`` per shard, then ``combine``) against the
    unsharded search, for a valid count ending mid-shard 3 and one ending
    in shard 1 (shards 2-3 empty); the sharded chamfer's value and frame
    gradient against ``losses/points.py``'s; then one world-size-1 NCCL
    group through ``knn_map_sharded`` and the sharded chamfer."""
    import tempfile

    import torch
    import torch.distributed as dist

    from e2eslam_tpu_torch.losses.points import _masked_mean, chamfer_distance
    from e2eslam_tpu_torch.losses.points_sharded import (
        chamfer_distance_map_sharded,
        map_to_frame_sum,
    )
    from e2eslam_tpu_torch.ops.knn_sharded import combine, knn_map_sharded, shard_search

    gen = torch.Generator(device="cuda").manual_seed(11)
    cap = SHARDS * SHARD_ROWS
    map_pts = surface_points(cap, gen, 0.01).contiguous()
    frame = view_points(SHARD_FRAME, gen)
    launches = {k: 0 for k in KERNEL_INFO}

    def virtual(nr, fr):
        """The shards' searches and parts, one after another: (combined
        search, chamfer value, per-shard lines)."""
        parts, lines, mf = [], [], 0.0
        for k in range(SHARDS):
            ref = map_pts[k * SHARD_ROWS:(k + 1) * SHARD_ROWS]
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            part, route = _shard_routes(knn, lambda: shard_search(
                fr.detach(), ref, k * SHARD_ROWS, nr, with_points=True))
            b.record()
            torch.cuda.synchronize()
            n_local = min(max(nr - k * SHARD_ROWS, 0), SHARD_ROWS)
            s_mf, route_mf = _shard_routes(knn, lambda: map_to_frame_sum(fr, ref, n_local,
                                                                       SHARD_FRAME))
            mf = mf + s_mf
            for key in launches:
                launches[key] += route[key] + route_mf[key]
            parts.append(part)
            lines.append({"shard": k, "nr_local": n_local, "search_ms": a.elapsed_time(b),
                          "search_route": [key for key, v in route.items() if v],
                          "chamfer_ba_route": [key for key, v in route_mf.items() if v]})
        d2, idx, pts = combine(*(torch.stack(t) for t in zip(*parts)))
        fm = _masked_mean(((fr - pts) ** 2).sum(dim=-1), None)
        return (d2, idx, pts), fm + mf / max(float(nr), 1.0), lines

    def shard_ba_picks(nr):
        """Each shard's map->frame nearest frame points, in map row order
        (the calls ``map_to_frame_sum`` makes)."""
        picks = []
        for k in range(SHARDS):
            n_local = min(max(nr - k * SHARD_ROWS, 0), SHARD_ROWS)
            ref = map_pts[k * SHARD_ROWS:(k + 1) * SHARD_ROWS]
            picks.append(knn.knn(ref, frame, SHARD_FRAME, n_local)[1][:n_local])
        return torch.cat(picks)

    for case, nr in (("mid-shard 3", 2_500_000), ("shards 2-3 empty", SHARD_ROWS + 200_000)):
        fr = frame.clone().requires_grad_(True)
        with Recorder(knn) as rec:
            (d2, idx, pts), value, lines = virtual(nr, fr)
        value.backward()
        g_s = fr.grad.clone()
        d_ref, i_ref = knn.knn(frame, map_pts, nr)
        fr_r = frame.clone().requires_grad_(True)
        v_r = chamfer_distance(fr_r, map_pts, n_a=SHARD_FRAME, n_b=nr)
        v_r.backward()
        torch.cuda.synchronize()
        q = frame.double()
        r = map_pts.double()
        tol = torch.maximum(knn.fp32_distance_bound(q, r[idx.long()]),
                            knn.fp32_distance_bound(q, r[i_ref.long()]))
        err = (d2.double() - d_ref.double()).abs()
        diff = idx != i_ref
        gap = (((q - r[idx.long()]) ** 2).sum(1) - ((q - r[i_ref.long()]) ** 2).sum(1)).abs()
        grad = chamfer_grad_check(knn, frame, map_pts, nr, g_s, fr_r.grad,
                                  (idx, shard_ba_picks(nr)),
                                  (i_ref, knn.knn(map_pts, frame, SHARD_FRAME, nr)[1]))
        line = {"phase": "sharded", "case": case, "nr": nr, "shards": lines,
                "distances_bitwise_equal": bool(torch.equal(d2, d_ref)),
                "max_abs_err": float(err.max()), "index_mismatches": int(diff.sum()),
                "mismatch_gap_over_tol_max": float((gap[diff] / tol[diff]).max())
                if bool(diff.any()) else 0.0,
                "chamfer": float(value.detach()), "chamfer_unsharded": float(v_r.detach()),
                "rtol": SHARDED_RTOL, **grad}
        print(json.dumps(line), flush=True)
        if bool((err > tol).any()):
            fail(f"sharded ({case}): distances differ from the unsharded search")
        if bool((gap[diff] > tol[diff]).any()):
            fail(f"sharded ({case}): indices differ where the nearest neighbour is unique")
        v_s, v_u = float(value.detach()), float(v_r.detach())
        if abs(v_s - v_u) > SHARDED_RTOL * abs(v_u):
            fail(f"sharded ({case}): chamfer {v_s} vs unsharded {v_u}")
        if grad["tie_gap_over_tol_max"] > 1.0 or grad["grad_err_over_bound_max"] > 1.0:
            fail(f"sharded ({case}): frame gradient {grad}")
        if case.startswith("mid"):
            # The shard-sized cold search (dense kernel): held and timed.
            compare_call(knn, "dense", rec.calls["dense"][1], "sharded shard", stats,
                         timing=True, stats_key="dense_sharded")

    # One NCCL group of one rank: the distributed entry points themselves.
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            before = launch_counts(knn)
            d2, idx = knn_map_sharded(None, frame, map_pts, 2_500_000)
            fr = frame.clone().requires_grad_(True)
            v = chamfer_distance_map_sharded(None, fr, map_pts, n_frame=SHARD_FRAME,
                                             n_map=2_500_000)
            v.backward()
            after = launch_counts(knn)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    d_ref, i_ref = knn.knn(frame, map_pts, 2_500_000)
    fr_r = frame.clone().requires_grad_(True)
    v_r = chamfer_distance(fr_r, map_pts, n_a=SHARD_FRAME, n_b=2_500_000)
    v_r.backward()
    # One shard: the same calls as the unsharded loss, the same picks.
    i_ba = knn.knn(map_pts, frame, SHARD_FRAME, 2_500_000)[1]
    nccl = {"phase": "sharded", "case": "nccl world 1",
            "distances_bitwise_equal": bool(torch.equal(d2, d_ref)),
            "indices_equal": bool(torch.equal(idx, i_ref)),
            "chamfer": float(v.detach()), "chamfer_unsharded": float(v_r.detach()),
            **chamfer_grad_check(knn, frame, map_pts, 2_500_000, fr.grad, fr_r.grad,
                                 (i_ref, i_ba), (i_ref, i_ba)),
            "launches": {k: after[k] - before[k] for k in after}}
    print(json.dumps(nccl), flush=True)
    if (not nccl["distances_bitwise_equal"]
            or abs(nccl["chamfer"] - nccl["chamfer_unsharded"])
            > SHARDED_RTOL * abs(nccl["chamfer_unsharded"])
            or nccl["grad_err_over_bound_max"] > 1.0):
        fail(f"sharded (nccl world 1): {nccl}")
    for key in launches:
        launches[key] += nccl["launches"][key]
    return launches


# The whole-sequence program against the per-keyframe loop: (label,
# profile_adaptation workload, frames, settings, seedless, held). Every run
# has deterministic algorithms (the flagship-based runs spread by
# 0.078-0.102 in mean abs_rel with the default ones, PERF.md section 2). Two
# things part a brute-path program run from its loop run by design, and
# Adam's normalised first steps carry either along the run: the program
# seeds each event's first search with the previous event's neighbours
# (the JAX program's cross-keyframe cache) where the loop seeds it from the
# map's tail, and a seed keeps a float32 near-tie the other search gives to
# another row; and the per-tensor Adam runs its capturable form in the
# program, which rounds the update otherwise (both within 1e-6 of optax's
# formula, ``phase_optimizers``). So the held brute runs drop the KNN's
# seeds (``seedless``: both sides search cold, the dense and resident
# kernels) and take the fused Adam (one kernel in both) or an optimizer of
# the port's own (one code in both), and the index path (no KNN) is held as
# it ships; the shipped brute runs are reported, held to equal keyframes
# and the first keyframe only. ``default_12_seedless_adam`` reports where
# the two Adam forms part.
FUSED = {"OPTIMIZATION__fused_update": True}
SEQUENCE_RUNS = (
    ("default_12", "config", 12, {}, False, False),
    ("default_12_seedless", "config", 12, FUSED, True, True),
    ("default_60", "config", 60, {}, False, False),
    ("default_60_seedless", "config", 60, FUSED, True, True),
    ("flagship_60", "flagship", 60, {}, False, True),
    ("gradicp_12", "gradicp", 12, {}, False, True),
    ("compact_60", "compact", 60, {}, False, True),
    ("chamfer_12", "chamfer", 12, {}, False, False),
    ("chamfer_12_seedless", "chamfer", 12, FUSED, True, True),
    # The per-tensor Adam: seedless, its two forms the one difference.
    ("default_12_seedless_adam", "config", 12, {}, True, False),
    ("active_window_12_seedless", "config", 12, {"MODEL__active_window": 163_840, **FUSED},
     True, True),
    ("sgd_12_seedless", "config", 12, {"OPTIMIZATION__optimizer": "SGD"}, True, True),
    # The brute path with a voxel pass every 4th keyframe: the program's
    # passes, launched with no read, against the loop's, on one map.
    ("compact_voxel_12_seedless", "config", 12,
     {"MODEL__compact_period": 4, "MODEL__compact_mode": "voxel",
      "MODEL__compact_live_voxel": 0.01, **FUSED}, True, True),
)
# Seedless runs whose program must equal its loop to the bit (every abs_rel,
# every map point, every pose): one optimizer code and cold searches in both.
SEQUENCE_EXACT = ("active_window_12_seedless", "sgd_12_seedless", "compact_voxel_12_seedless")
# Runs whose program's host synchronisations are counted
# (``set_sync_debug_mode("warn")``): over the whole run, and from the end of
# the capture (event 1) to the end of the last replay or pass, where a
# compacting run must make none.
SEQUENCE_SYNC_COUNTED = ("default_12", "compact_60")
SEQUENCE_FIRST_TOL = 1e-3  # the first two keyframes' abs_rel, relative (the run tolerance)
SEQUENCE_MEAN_TOL = 0.005  # mean abs_rel (PERF.md section 2)


@contextlib.contextmanager
def _seedless():
    """The engine's KNN searches with their warm-start seeds dropped."""
    from e2eslam_tpu_torch.engine import refine
    from e2eslam_tpu_torch.losses import points

    search = refine.knn

    def cold(query, ref, nr=None, nq=None, init_idx=None, q_perm=None):
        return search(query, ref, nr, nq)

    refine.knn = points.knn = cold
    try:
        yield
    finally:
        refine.knn = points.knn = search


class PassTimer:
    """CUDA events around every ``compact_now`` call of ``engines`` (a
    program's passes run inside ``compact_in_place``), recorded on the
    current stream with no synchronisation; ``ms()`` reads them after the
    run."""

    def __init__(self, engines):
        import torch

        self.events = []
        for engine in engines:
            def timed(*args, _now=engine.compact_now, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _now(*args, **kw)
                end.record()
                self.events.append((start, end))
                return out

            engine.compact_now = timed

    def ms(self):
        import torch

        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


class _MarkedGraph:
    """A captured graph whose every replay calls ``mark`` after it."""

    def __init__(self, graph, mark):
        self._graph, self._mark = graph, mark

    def replay(self):
        self._graph.replay()
        self._mark()


class SyncSpan:
    """The host synchronisations a program run makes from the end of its
    graph capture (event 1, before its replay) to the end of its last replay or
    compaction pass: the ``set_sync_debug_mode("warn")`` warnings recorded
    in ``caught`` (a ``warnings.catch_warnings(record=True)`` list) over
    that span. ``owner`` captures the graph (``_capture_event``), each of
    ``engines`` runs the program's passes (``compact_in_place``)."""

    def __init__(self, owner, engines, caught):
        self.caught, self.start, self.end = caught, None, None
        capture = owner._capture_event

        def captured(*args, **kw):
            graph = capture(*args, **kw)
            self.start = self.end = len(caught)
            return _MarkedGraph(graph, self._mark)

        owner._capture_event = captured
        for engine in engines:
            def marked(*args, _pass=engine.compact_in_place, **kw):
                out = _pass(*args, **kw)
                self._mark()
                return out

            engine.compact_in_place = marked

    def _mark(self):
        if self.start is not None:
            self.end = len(self.caught)

    @property
    def syncs(self):
        """None when no graph was captured."""
        return None if self.start is None else self.end - self.start


def _sequence_run(knn, workload, frames, program, rec=None, sync_warn=False, seedless=False,
                  **settings):
    """One run of a profile_adaptation workload cut to ``frames``, with
    deterministic algorithms and ``settings`` (``SECTION__key``: value),
    through the whole-sequence program (its replays and compaction passes
    under ``set_sync_debug_mode("error")``: a synchronisation raises) or the
    per-keyframe loop. With ``sync_warn`` the host synchronisations are
    counted, the program's also from event 1 to its end (``SyncSpan``); each
    compaction pass is timed (``PassTimer``, ``pass_ms``). Returns (result,
    line); the line's ``launches`` are
    the kernels' launches on the device: the eager ones plus each launch
    captured in the graph times its replays (the wrappers' counts and a
    Recorder see a captured launch once, at capture, where it does not
    run)."""
    import warnings

    import torch

    from e2eslam_tpu_torch.apps.profile_adaptation import WORKLOADS
    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    cfg = WORKLOADS[workload](load_yaml(default_config_path()))
    cfg.DEMO.sequence_length = frames
    for key, value in settings.items():
        sec, flag = key.split("__")
        cfg[sec][flag] = value
    runner = OnlineAdaptation(cfg)
    runner.use_sequence_program = program
    captured = {}
    if program:
        runner.engine.replay_sync_mode = "error"
        capture = runner.engine._capture_event

        def counted(*args, **kw):
            before = launch_counts(knn)
            graph = capture(*args, **kw)
            captured.update({k: n - before[k] for k, n in launch_counts(knn).items()})
            return graph

        runner.engine._capture_event = counted
    passes = PassTimer([runner.engine])
    _reset(knn)
    with algorithms(True), rec or contextlib.nullcontext(), \
            _seedless() if seedless else contextlib.nullcontext(), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        span = SyncSpan(runner.engine, [runner.engine], caught) if program and sync_warn else None
        if sync_warn:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            result = runner.run(verbose=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counted_launches = launch_counts(knn)
    replays = max(result["num_keyframes"] - 1, 0) if result["graphs"] else 0
    launches = {k: n - captured.get(k, 0) + captured.get(k, 0) * replays
                for k, n in counted_launches.items()}
    busy = result["elapsed_s"] - result["capture_s"]
    line = {"phase": "sequence", "workload": workload, "frames": frames, "settings": settings,
            "program": result["sequence_program"], "graphs": result["graphs"],
            "capture_s": result["capture_s"], "elapsed_s": result["elapsed_s"],
            "steps_per_sec": result["steps_per_sec"],
            "steps_per_sec_no_capture": result["refine_steps"] / busy if busy > 0 else 0.0,
            "keyframes": result["num_keyframes"], "mean_abs_rel": result["mean_abs_rel"],
            "abs_rel_first_two": [m["abs_rel"] for m in result["metrics"][:2]],
            "map_points": result["map_points"], "ate": result["ate"], "rpe": result["rpe"],
            "launches": launches, "captured_launches": captured, "replays": replays,
            "compactions": [c["keyframe"] for c in result["compactions"]],
            "pass_ms": passes.ms()}
    if sync_warn:
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        line.update(host_syncs=syncs, host_syncs_per_event=syncs / max(result["num_keyframes"], 1))
        if span is not None:
            line["host_syncs_from_event_1"] = span.syncs
    return result, line


def _gaps(a, b):
    """(each keyframe's relative abs_rel gap, mean abs_rel gap, map gap) of
    run ``a`` against run ``b``."""
    rel = [abs(x["abs_rel"] - y["abs_rel"]) / y["abs_rel"]
           for x, y in zip(a["metrics"], b["metrics"])]
    return rel, abs(a["mean_abs_rel"] - b["mean_abs_rel"]), abs(a["map_points"]
                                                               - b["map_points"])


def _check_pair(label, prog, loop, pline, lline, held):
    """The program's run against the loop's: equal keyframes and compaction
    events, finite abs_rel, the first keyframe's abs_rel within
    SEQUENCE_FIRST_TOL and, when ``held``, the second's too, the mean within
    SEQUENCE_MEAN_TOL and the map within the tie allowance
    max(4, count // 1000) (tests/test_engine.py:506-508); a run of
    SEQUENCE_EXACT equal to the bit. Returns the gaps, with where the two
    first part (``first_parted``: the keyframe, None when equal)."""
    rel, mean_gap, map_gap = _gaps(prog, loop)
    parted = [k for k, (a, b) in enumerate(zip(prog["metrics"], loop["metrics"]))
              if a["abs_rel"] != b["abs_rel"]]
    bitwise = (not parted and prog["map_points"] == loop["map_points"]
               and (prog["est_poses"] == loop["est_poses"]).all())
    if label in SEQUENCE_EXACT and not bitwise:
        fail(f"sequence {label}: the program parts from the loop at keyframe "
             f"{parted[:1]} (abs_rel gaps {rel[:4]}, map {map_gap})")
    allowance = max(4, loop["map_points"] // 1000)
    if not prog["sequence_program"] or loop["sequence_program"]:
        fail(f"sequence {label}: the program and the loop were not the runs' paths")
    if prog["graphs"] != (1 if prog["num_keyframes"] > 2 else 0):
        fail(f"sequence {label}: {prog['graphs']} graphs captured")
    if prog["keyframes"] != loop["keyframes"]:
        fail(f"sequence {label}: keyframes differ from the loop's")
    if pline["compactions"] != lline["compactions"]:
        fail(f"sequence {label}: compaction events differ from the loop's")
    if not all(map(_finite, [m["abs_rel"] for m in prog["metrics"]])):
        fail(f"sequence {label}: non-finite abs_rel")
    if max(rel[:2] if held else rel[:1]) > SEQUENCE_FIRST_TOL:
        fail(f"sequence {label}: the first keyframes' abs_rel part from the loop's "
             f"by {rel[:2]}")
    if held and mean_gap > SEQUENCE_MEAN_TOL:
        fail(f"sequence {label}: mean abs_rel {prog['mean_abs_rel']} against the loop's "
             f"{loop['mean_abs_rel']}")
    if held and map_gap > allowance:
        fail(f"sequence {label}: map points {prog['map_points']} against the loop's "
             f"{loop['map_points']}")
    return {"held": held, "bitwise_equal": bool(bitwise),
            "first_parted": parted[0] if parted else None, "first_two_rel_gap": rel[:2],
            "max_rel_gap": max(rel), "mean_abs_rel_gap": mean_gap, "map_gap": map_gap,
            "map_allowance": allowance}


def phase_sequence(knn, stats, smi):
    """The whole-sequence program (engine/refine.py::process_sequence: on
    the card event 0 eager, then one CUDA graph captured at event 1 and
    replayed for every later event) against the per-keyframe loop, each run of
    SEQUENCE_RUNS through both at 320x256, ResNet-18, R = 3, deterministic
    algorithms (``_check_pair``). First the data path alone: the default
    config's 12 frames at learning rate 0 (the network frozen), where the
    program must give the loop's every abs_rel and map point. No host
    synchronisation inside a replay or a compaction pass (the runs raise on
    one); host syncs an event counted for SEQUENCE_SYNC_COUNTED
    (``set_sync_debug_mode("warn")``), and none allowed from event 1 to the
    end of compact_60's program; each pass's device time printed
    (``pass_ms``, program and loop). The
    default program's captured candidate call, the chamfer program's
    captured map->frame resident call and a dense call on the former's
    inputs, all with the counts given as device tensors, are held against
    the plain versions. Returns the shipped program runs' device launches
    per kernel (eager launches plus captured launches times replays)."""
    import torch

    _sequence_run(knn, "config", 4, True)  # warm-up: cuDNN's first calls
    frozen = {"OPTIMIZATION__learning_rate": 0.0}
    prog, pline = _sequence_run(knn, "config", 12, True, **frozen)
    loop, lline = _sequence_run(knn, "config", 12, False, **frozen)
    rel, _, map_gap = _gaps(prog, loop)
    print(json.dumps({"phase": "sequence", "run": "default_12_frozen", "max_rel_gap": max(rel),
                      "map_gap": map_gap, "keyframes": prog["num_keyframes"]}), flush=True)
    if prog["keyframes"] != loop["keyframes"] or max(rel) > 1e-6 or map_gap:
        fail(f"sequence default_12_frozen: the program's data path parts from the loop's "
             f"(abs_rel {max(rel)}, map {map_gap})")
    totals = {key: 0 for key in KERNEL_INFO}
    for label, workload, frames, settings, seedless, held in SEQUENCE_RUNS:
        rec = None
        if label == "default_12":
            rec = Recorder(knn)
        elif label == "chamfer_12":
            rec = Recorder(knn, frame_rows=320 * 256)
        sync_warn = label in SEQUENCE_SYNC_COUNTED
        prog, pline = _sequence_run(knn, workload, frames, True, rec, sync_warn, seedless,
                                    **settings)
        loop, lline = _sequence_run(knn, workload, frames, False, sync_warn=sync_warn,
                                    seedless=seedless, **settings)
        for key in totals:
            totals[key] += 0 if seedless else pline["launches"][key]
        gaps = _check_pair(label, prog, loop, pline, lline, held)
        print(json.dumps({"phase": "sequence", "run": label, "program": pline, "loop": lline,
                          "gaps": gaps,
                          "speedup": pline["steps_per_sec"] / lline["steps_per_sec"],
                          "speedup_no_capture": pline["steps_per_sec_no_capture"]
                          / lline["steps_per_sec"], "nvidia_smi": smi}), flush=True)
        if label == "default_12":
            if pline["captured_launches"]["cand"] == 0:
                fail("sequence default_12: the captured event launches no candidate kernel")
            if pline["host_syncs"] > lline["host_syncs"]:
                fail("sequence default_12: the program synchronised more than the loop")
            cand = rec.calls["cand"][1]
            if not knn.is_device_count(cand[-2]):
                fail("sequence default_12: the captured candidate call took a host count")
            compare_call(knn, "cand", cand, "sequence captured (device counts)", stats,
                         stats_key="cand_sequence")
            q4, r4, _, s0, i0, _, _, nq, nr, _ = cand
            dense_args = (q4, r4, knn._tile_boxes(r4[:, :3], knn.RT), s0, i0, nq, nr, knn.RT)
            compare_call(knn, "dense", dense_args, "sequence inputs (device counts)", stats,
                         stats_key="dense_sequence")
        if sync_warn and pline["compactions"] and pline["host_syncs_from_event_1"] != 0:
            fail(f"sequence {label}: the program synchronised "
                 f"{pline['host_syncs_from_event_1']} times from event 1 to its end")
        if label == "chamfer_12":
            if pline["captured_launches"]["resident"] == 0:
                fail("sequence chamfer_12: the captured event launches no resident kernel")
            ba = rec.calls["resident:ba"][1]
            if not knn.is_device_count(ba[-3]):
                fail("sequence chamfer_12: the captured map->frame call took a host count")
            compare_call(knn, "resident", ba, "sequence captured b->a (device counts)", stats,
                         plain=resident_plain_by_tiles(knn), stats_key="resident_sequence")
    torch.cuda.synchronize()
    return totals


# --- the optimizers' formula on the card ------------------------------------

OPTAX_STEPS = 30
OPTAX_TOL = 1e-6  # relative, as tests/test_torch_optim.py holds the optimizers
OPTAX_SHAPES = {"conv": (4, 3, 3, 3), "bias": (4,), "bn": (7,), "fc": (5, 6)}


def optax_reference(kind, init, grads, lrs):
    """optax's update in float64 numpy, transcribed: ``adam``
    (``scale_by_adam``: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 +
    b2 nu``, bias-corrected by ``1 - b^count``, ``mu_hat / (sqrt(nu_hat) +
    eps)``, .9/.999/1e-8) or ``sgd`` (``add_decayed_weights(1e-3)`` then
    ``trace(0.9)``), then ``-lr`` of the step's schedule and
    ``apply_updates``. ``init`` ``{name: array}``, ``grads`` a list of such,
    ``lrs`` one learning rate per update. tests/test_torch_optim.py holds
    it against optax itself."""
    import numpy as np

    b1, b2, eps = 0.9, 0.999, 1e-8
    out = {}
    for name, p0 in init.items():
        p = np.asarray(p0, np.float64)
        mu, nu = np.zeros_like(p), np.zeros_like(p)
        for t, (g_all, lr) in enumerate(zip(grads, lrs)):
            g = np.asarray(g_all[name], np.float64)
            if kind == "adam":
                mu = (1 - b1) * g + b1 * mu
                nu = (1 - b2) * g * g + b2 * nu
                c = t + 1
                u = (mu / (1 - b1 ** c)) / (np.sqrt(nu / (1 - b2 ** c)) + eps)
            else:
                mu = (g + 1e-3 * p) + 0.9 * mu
                u = mu
            p = p + (-lr) * u
        out[name] = p
    return out


def _optimizer_run(make, init, grads, cfg, device_schedule):
    """``OPTAX_STEPS`` updates of the optimizer ``make(params)`` builds, on
    the card, its learning rate from the config's schedule: the host
    ``LambdaLR`` or ``DeviceSchedule``'s device tensor. Returns the final
    parameters (float64 numpy)."""
    import torch

    from e2eslam_tpu_torch.engine.optim import DeviceSchedule, _lr_lambda

    dev = torch.device("cuda")
    params = {k: torch.nn.Parameter(torch.tensor(v, device=dev)) for k, v in init.items()}
    opt = make(list(params.values()))
    sched = torch.optim.lr_scheduler.LambdaLR(opt, _lr_lambda(cfg.OPTIMIZATION))
    ds = DeviceSchedule(cfg, opt, sched, dev) if device_schedule else None
    for g in grads:
        for k, p in params.items():
            p.grad = torch.tensor(g[k], device=dev)
        if ds is None:
            opt.step()
            sched.step()
        else:
            ds.set_lr()
            opt.step()
            ds.stepped()
    if ds is not None:
        ds.exit()
    torch.cuda.synchronize()
    return {k: p.detach().double().cpu().numpy() for k, p in params.items()}


def phase_optimizers(smi):
    """The optimizers the programs run, on the card, against
    ``optax_reference``: OPTAX_STEPS updates across a StepLR decay (every
    10 updates, gamma 0.5, learning rate 1e-2; a zero gradient on one tensor
    now and then). torch's Adam in its ``capturable`` form under
    ``DeviceSchedule`` (the program's per-tensor Adam) and in its default
    form with the host scheduler (the loop's), each held to OPTAX_TOL, and
    their gap reported; the port's SGD from ``DeviceSchedule`` and from the
    host scheduler, each held to OPTAX_TOL and the two equal to the bit
    (loop and program run one code)."""
    import numpy as np
    import torch

    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.engine.optim import SGD

    cfg = load_yaml(default_config_path())
    cfg.OPTIMIZATION.update({"learning_rate": 1e-2, "schedular": "StepLR",
                             "schedular_step_size": 10, "schedular_gamma": 0.5})
    init, grads = optax_inputs()
    lrs = [1e-2 * 0.5 ** (t // 10) for t in range(OPTAX_STEPS)]

    def gap(got, want):
        return max(float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
                   for k in want)

    runs = {
        ("adam", "torch_default"): _optimizer_run(
            lambda ps: torch.optim.Adam(ps, lr=1e-2), init, grads, cfg, False),
        ("adam", "torch_capturable_device_lr"): _optimizer_run(
            lambda ps: torch.optim.Adam(ps, lr=1e-2, capturable=True), init, grads, cfg, True),
        ("sgd", "port"): _optimizer_run(
            lambda ps: SGD(ps, lr=1e-2, foreach=True), init, grads, cfg, False),
        ("sgd", "port_device_lr"): _optimizer_run(
            lambda ps: SGD(ps, lr=1e-2, foreach=True), init, grads, cfg, True),
    }
    want = {kind: optax_reference(kind, init, grads, lrs) for kind in ("adam", "sgd")}
    line = {"phase": "optimizers", "steps": OPTAX_STEPS, "tolerance": OPTAX_TOL,
            "nvidia_smi": smi}
    for (kind, form), got in runs.items():
        line.setdefault(kind, {})[form] = gap(got, want[kind])
    line["adam"]["default_vs_capturable"] = gap(runs[("adam", "torch_capturable_device_lr")],
                                                runs[("adam", "torch_default")])
    line["sgd"]["host_equals_device_lr"] = all(
        np.array_equal(runs[("sgd", "port")][k], runs[("sgd", "port_device_lr")][k])
        for k in init)
    print(json.dumps(line), flush=True)
    for kind, forms in line.items():
        if kind in ("adam", "sgd"):
            for form, g in forms.items():
                if form != "default_vs_capturable" and isinstance(g, float) and g > OPTAX_TOL:
                    fail(f"optimizers: {kind} {form} is {g:.3g} off optax's formula")
    if not line["sgd"]["host_equals_device_lr"]:
        fail("optimizers: the port's SGD under DeviceSchedule parts from its host schedule")
    return line


def optax_inputs():
    """tests/test_torch_optim.py's parameter tree and OPTAX_STEPS gradients
    (a zero gradient on one tensor now and then), seeded from numpy."""
    import numpy as np

    rng = np.random.default_rng(0)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in OPTAX_SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in OPTAX_SHAPES.items()}
             for _ in range(OPTAX_STEPS)]
    for g in grads[::7]:
        g["bn"][:] = 0.0
    return init, grads


# --- the program over B sequences against the per-event loop ----------------

PROGRAM_B = 4
PROGRAM_FLAGSHIP_FRAMES = 60
PROGRAM_PROFILE_FRAMES = 8
PROGRAM_CHAMFER_FRAMES = 8


def _batched_program_run(knn, cfg, seqs, dispatch, *, seedless=False, frame_rows=None,
                         sync_warn=False):
    """One ``ParallelAdaptation`` run of ``seqs`` through ``dispatch``
    (``run_batched``), with deterministic algorithms: the program's replays
    and compaction passes under ``set_sync_debug_mode("error")`` (a
    synchronisation raises), the launches each kernel made inside the
    captured event counted and its calls there recorded (a Recorder with
    ``frame_rows``), each compaction pass timed (``PassTimer``,
    ``pass_ms``). With ``sync_warn`` the host synchronisations are counted,
    the program's also from event 1 to its end (``SyncSpan``). Returns
    (line, result, the capture's Recorder)."""
    import warnings

    import torch

    from e2eslam_tpu_torch.apps.profile_adaptation import run_batched

    captured, rec, probes = {}, Recorder(knn, frame_rows=frame_rows), {}

    def hook(par):
        par.par.engines[0].replay_sync_mode = "error"
        capture = par._capture_event

        def counted(*args, **kw):
            before = launch_counts(knn)
            with rec:
                graph = capture(*args, **kw)
            captured.update({k: n - before[k] for k, n in launch_counts(knn).items()})
            return graph

        par._capture_event = counted
        probes["passes"] = PassTimer(par.par.engines)
        if sync_warn and dispatch == "whole":
            probes["span"] = SyncSpan(par, par.par.engines, caught)

    counting = warnings.catch_warnings(record=True) if sync_warn else contextlib.nullcontext([])
    with algorithms(True), _seedless() if seedless else contextlib.nullcontext(), \
            counting as caught:
        if sync_warn:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
        try:
            line, out = run_batched(cfg, seqs, dispatch=dispatch, runner_hook=hook)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    replays = max(out["num_events"] - 1, 0) if out["graphs"] else 0
    eager = launch_counts(knn)
    line["launches"] = {k: n - captured.get(k, 0) + captured.get(k, 0) * replays
                        for k, n in eager.items()}
    line.update(captured_launches=captured, replays=replays, seedless=seedless,
                pass_ms=probes["passes"].ms(),
                compactions=[[c["keyframe"] for c in r["compactions"]]
                             for r in out["per_sequence"]])
    if sync_warn:
        line["host_syncs"] = sum("synchroniz" in str(w.message) for w in caught)
        if "span" in probes:
            line["host_syncs_from_event_1"] = probes["span"].syncs
    return line, out, rec


def _metrics_equal(a, b) -> bool:
    """Whether two runs' per-keyframe metrics agree to the bit, the nested
    gradient norms and debug images (arrays) included."""
    import numpy as np

    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_metrics_equal(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(map(_metrics_equal, a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def _batched_equal(a, b):
    """Whether two runs' sequences agree to the bit: keyframes, every
    keyframe's metrics, map points, estimated poses."""
    import numpy as np

    return all(x["keyframes"] == y["keyframes"] and _metrics_equal(x["metrics"], y["metrics"])
               and x["map_points"] == y["map_points"]
               and np.array_equal(x["est_poses"], y["est_poses"])
               for x, y in zip(a["per_sequence"], b["per_sequence"]))


def _batched_gaps(prog, loop):
    """Per sequence: keyframes equal, the first two keyframes' relative
    abs_rel gap, the mean abs_rel gap, the map gap."""
    gaps = []
    for x, y in zip(prog["per_sequence"], loop["per_sequence"]):
        rel = [abs(a - b) / b for a, b in zip(x["per_pair_abs_rel"], y["per_pair_abs_rel"])]
        gaps.append({"keyframes_equal": x["keyframes"] == y["keyframes"],
                     "first_two_rel_gap": rel[:2], "max_rel_gap": max(rel or [0.0]),
                     "mean_gap": abs(x["mean_abs_rel"] - y["mean_abs_rel"]),
                     "map_gap": abs(x["map_points"] - y["map_points"])})
    return gaps


def commit_select_ms(cfg, b, reps=20):
    """The masked commit's selects (``parallel/mesh.py::save_rows`` and
    ``commit_rows``: a copy of each stepped tensor of ``b`` stacked networks
    and of its Adam moments, then a ``where`` over each), captured as a CUDA
    graph as the program runs them, one replay timed with CUDA events (the
    median of ``reps``): what an all-active graph without them would save a
    step. Returns (ms, bytes kept)."""
    import torch

    from e2eslam_tpu_torch.models.depth_net import make_depth_model
    from e2eslam_tpu_torch.parallel.mesh import ParallelRefinement, commit_rows, save_rows

    pr = ParallelRefinement(cfg, make_depth_model(cfg), map_capacity=1, n_seq=b)
    state = pr.init_state()
    for p in state.params.values():
        if p.requires_grad:
            p.grad = torch.randn_like(p) * 1e-3
    pr._commit(state, None)  # the optimizer makes its state
    mask = torch.ones(b, dtype=torch.bool, device=pr.device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        commit_rows(save_rows(state.optimizer), mask)  # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        saved = save_rows(state.optimizer)
        commit_rows(saved, mask)
    kept = sum(t.numel() * t.element_size() for t, _ in saved)
    return timed(graph.replay, reps), kept


def phase_batched_program(knn, stats, smi):
    """``ParallelAdaptation.run(dispatch="whole")``, the program over B =
    PROGRAM_B sequences (on the card event 0 eager, then one CUDA graph
    captured at event 1 and replayed), against its per-event loop (``dispatch="event"``),
    with deterministic algorithms:
      * the default config, BATCHED_FRAMES ragged frames
        (``_batched_sequences``): seedless with the fused Adam, equal to the
        bit; as it ships (seeds, the per-tensor Adam), equal keyframes and
        the first keyframe within SEQUENCE_FIRST_TOL, the later gaps and the
        mean's against SEQUENCE_MEAN_TOL reported (each event's first search
        is seeded by the previous event in the program, from the map's tail
        in the loop, a near-tie picked otherwise moves later keyframes, and
        the program's Adam rounds in its capturable form, as the shipped
        single-sequence runs of ``phase_sequence``); no synchronisation
        inside a replay; the captured event launches the candidate kernel,
        and one captured call is held against its plain version;
      * the chamfer config (``chamfer_config``) on the same sequences'
        first PROGRAM_CHAMFER_FRAMES frames, as it ships: equal keyframes;
        its captured map->frame search launches the resident kernel, one
        captured call held against its plain version;
      * the flagship settings (``flagship_config``), PROGRAM_FLAGSHIP_FRAMES
        frames of ``make_sequences``: no KNN, the fused Adam: equal to the
        bit;
      * compaction inside the program: the default
        config's ragged sequences with a voxel pass every 4th event,
        seedless with the fused Adam, and the flagship sequences with a
        projective pass every 10th (``compact_config``): equal to the bit,
        the same passes with the same counts as the loop's, no host
        synchronisation from event 1 to the end, each pass's device time
        (``pass_ms``) beside the loop's.
    Then, with the default algorithms, each config timed (program, loop,
    loop, program for the default config, program and loop for the
    flagship: aggregate steps/s, ``capture_s``) and
    PROGRAM_PROFILE_FRAMES frames of each under the profiler
    (``profile_batched``: idle share, host syncs, host launch calls and
    device kernels an event), and the masked commit's selects timed
    (``commit_select_ms``). Returns the shipped program run's device
    launches per kernel (eager launches plus captured ones times replays)."""
    from e2eslam_tpu_torch.apps.profile_adaptation import (
        chamfer_config,
        compact_config,
        flagship_config,
        make_sequences,
        profile_batched,
        run_batched,
    )
    from e2eslam_tpu_torch.config import default_config_path, load_yaml

    t0 = time.perf_counter()
    cfg = _batched_cfg()
    _, seqs = _batched_sequences(PROGRAM_B)
    for dispatch in ("whole", "event"):  # warm-up: cuDNN's first calls
        run_batched(cfg, tuple(x[:, :4] if x.ndim > 3 else x for x in seqs), dispatch=dispatch)

    # Seedless with the fused Adam: the same function, to the bit.
    fused = _batched_cfg()
    fused.OPTIMIZATION.fused_update = True
    p, prog, _ = _batched_program_run(knn, fused, seqs, "whole", seedless=True)
    l, loop, _ = _batched_program_run(knn, fused, seqs, "event", seedless=True)
    equal = _batched_equal(prog, loop)
    print(json.dumps({"phase": "batched_program", "phase_s": time.perf_counter() - t0,
                      "run": "default_seedless_fused",
                      "program": p, "loop": l, "bitwise_equal": equal,
                      "gaps": _batched_gaps(prog, loop)}), flush=True)
    if p["dispatch"] != "whole" or p["graphs"] != 1:
        fail(f"batched_program: the program ran {p['dispatch']} with {p['graphs']} graphs")
    if not equal:
        fail("batched_program default_seedless_fused: the program parts from the loop")

    # As it ships: seeds threaded, the per-tensor Adam.
    p, prog, rec = _batched_program_run(knn, cfg, seqs, "whole")
    l, loop, _ = _batched_program_run(knn, cfg, seqs, "event")
    gaps = _batched_gaps(prog, loop)
    print(json.dumps({"phase": "batched_program", "phase_s": time.perf_counter() - t0,
                      "run": "default", "program": p, "loop": l, "gaps": gaps,
                      "mean_within_tol": all(g["mean_gap"] <= SEQUENCE_MEAN_TOL for g in gaps),
                      "nvidia_smi": smi}), flush=True)
    for i, g in enumerate(gaps):
        if not g["keyframes_equal"]:
            fail(f"batched_program default: sequence {i} chose other keyframes")
        if g["first_two_rel_gap"][0] > SEQUENCE_FIRST_TOL:
            fail(f"batched_program default: sequence {i} parts from the loop: {g}")
    if len(set(p["keyframes"])) < 2:
        fail(f"batched_program: the schedules are not ragged: {p['keyframes']}")
    if p["captured_launches"].get("cand", 0) == 0:
        fail("batched_program: the captured event launches no cand kernel")
    args = rec.calls["cand"][1]
    if not knn.is_device_count(args[-2]):
        fail("batched_program: the captured cand call took a host count")
    compare_call(knn, "cand", args, "batched_program captured (device counts)", stats,
                 stats_key="cand_batched_program")
    launches = p["launches"]

    # The chamfer (its map->frame search on the resident kernel inside the
    # graph; every later step-0 search is seeded by the previous event, so
    # the tail seed's resident call runs at event 0 alone), as it ships.
    ccfg = chamfer_config(_batched_cfg())
    ccfg.DEMO.frame_threshold = cfg.DEMO.frame_threshold  # the sequences' schedules
    ccfg.DEMO.sequence_length = PROGRAM_CHAMFER_FRAMES
    cseqs = tuple(x[:, :PROGRAM_CHAMFER_FRAMES] if x.ndim > 3 else x for x in seqs)
    cp, cprog, crec = _batched_program_run(knn, ccfg, cseqs, "whole", frame_rows=320 * 256)
    cl, cloop, _ = _batched_program_run(knn, ccfg, cseqs, "event")
    cgaps = _batched_gaps(cprog, cloop)
    print(json.dumps({"phase": "batched_program", "phase_s": time.perf_counter() - t0,
                      "run": "chamfer", "program": cp,
                      "loop": cl, "gaps": cgaps, "nvidia_smi": smi}), flush=True)
    if not all(g["keyframes_equal"] for g in cgaps):
        fail("batched_program chamfer: the program chose other keyframes than the loop")
    if cp["captured_launches"].get("resident", 0) == 0:
        fail("batched_program chamfer: the captured event launches no resident kernel")
    ba = crec.calls["resident:ba"][1]
    if not knn.is_device_count(ba[-3]):
        fail("batched_program chamfer: the captured map->frame call took a host count")
    compare_call(knn, "resident", ba, "batched_program captured b->a (device counts)", stats,
                 plain=resident_plain_by_tiles(knn), stats_key="resident_batched_program")
    for key in launches:
        launches[key] += cp["launches"][key]

    fcfg = flagship_config(load_yaml(default_config_path()))
    fcfg.DEMO.sequence_length = PROGRAM_FLAGSHIP_FRAMES
    fseqs = make_sequences(PROGRAM_B, PROGRAM_FLAGSHIP_FRAMES, 256, 320)
    print(json.dumps({"phase": "batched_program", "phase_s": time.perf_counter() - t0,
                      "run": "flagship sequences made"}), flush=True)
    fp, fprog, _ = _batched_program_run(knn, fcfg, fseqs, "whole")
    fl, floop, _ = _batched_program_run(knn, fcfg, fseqs, "event")
    fequal = _batched_equal(fprog, floop)
    print(json.dumps({"phase": "batched_program", "phase_s": time.perf_counter() - t0,
                      "run": "flagship", "program": fp,
                      "loop": fl, "bitwise_equal": fequal, "gaps": _batched_gaps(fprog, floop),
                      "nvidia_smi": smi}), flush=True)
    if not fequal:
        fail("batched_program flagship: the program parts from the loop")
    if any(fp["launches"].values()):
        fail(f"batched_program flagship: KNN launches {fp['launches']}")

    # Compaction inside the program, each pass launched with no read.
    vcfg = _batched_cfg()
    vcfg.OPTIMIZATION.fused_update = True
    vcfg.MODEL.update({"compact_period": 4, "compact_mode": "voxel"})
    pcfg = compact_config(load_yaml(default_config_path()))
    pcfg.DEMO.sequence_length = PROGRAM_FLAGSHIP_FRAMES
    for name, c, data, seedless in (("default_voxel_seedless_fused", vcfg, seqs, True),
                                    ("flagship_projective", pcfg, fseqs, False)):
        pline, prun, _ = _batched_program_run(knn, c, data, "whole", seedless=seedless,
                                              sync_warn=True)
        lline, lrun, _ = _batched_program_run(knn, c, data, "event", seedless=seedless)
        equal = _batched_equal(prun, lrun)
        same_passes = all(x["compactions"] == y["compactions"] for x, y in
                          zip(prun["per_sequence"], lrun["per_sequence"]))
        print(json.dumps({"phase": "batched_program", "phase_s": time.perf_counter() - t0,
                          "run": name, "program": pline, "loop": lline, "bitwise_equal": equal,
                          "same_passes": same_passes, "gaps": _batched_gaps(prun, lrun),
                          "nvidia_smi": smi}), flush=True)
        if pline["dispatch"] != "whole" or pline["graphs"] != 1:
            fail(f"batched_program {name}: the program ran {pline['dispatch']} with "
                 f"{pline['graphs']} graphs")
        if not all(pline["compactions"]) or not same_passes:
            fail(f"batched_program {name}: passes {pline['compactions']} against the loop's "
                 f"{lline['compactions']}")
        if not equal:
            fail(f"batched_program {name}: the program parts from the loop")
        if pline["host_syncs_from_event_1"] != 0:
            fail(f"batched_program {name}: the program synchronised "
                 f"{pline['host_syncs_from_event_1']} times from event 1 to its end")

    # The observability outputs (each sequence's gradient norms and debug
    # images) carried by the program, seedless with the fused Adam.
    ocfg = _batched_cfg()
    ocfg.OPTIMIZATION.fused_update = True
    ocfg.VIZ.log_gradients, ocfg.DEBUG.plot, ocfg.DEBUG.plot_path = True, True, None
    op, oprog, _ = _batched_program_run(knn, ocfg, seqs, "whole", seedless=True, sync_warn=True)
    ol, oloop, _ = _batched_program_run(knn, ocfg, seqs, "event", seedless=True)
    equal = _batched_equal(oprog, oloop)
    carried = all("grad_norms" in m and "debug_images" in m
                  for r in (oprog, oloop) for x in r["per_sequence"] for m in x["metrics"])
    print(json.dumps({"phase": "batched_program", "phase_s": time.perf_counter() - t0,
                      "run": "default_observed_seedless_fused", "program": op, "loop": ol,
                      "bitwise_equal": equal, "outputs_carried": carried,
                      "gaps": _batched_gaps(oprog, oloop), "nvidia_smi": smi}), flush=True)
    if op["dispatch"] != "whole" or op["graphs"] != 1:
        fail(f"batched_program default_observed_seedless_fused: the program ran "
             f"{op['dispatch']} with {op['graphs']} graphs")
    if not carried:
        fail("batched_program default_observed_seedless_fused: a keyframe lacks its norms "
             "or images")
    if not equal:
        fail("batched_program default_observed_seedless_fused: the program parts from the loop")
    if op["host_syncs_from_event_1"] != 0:
        fail(f"batched_program default_observed_seedless_fused: the program synchronised "
             f"{op['host_syncs_from_event_1']} times from event 1 to its end")

    # Default algorithms: timed in turns, then profiled.
    for name, c, x, turns in (("default", cfg, seqs, ("whole", "event", "event", "whole")),
                              ("flagship", fcfg, fseqs, ("whole", "event"))):
        timed_runs = []
        for dispatch in turns:
            line, _ = run_batched(c, x, dispatch=dispatch)
            timed_runs.append({k: line[k] for k in (
                "dispatch", "aggregate_steps_per_sec", "steps_per_sec_no_capture", "elapsed_s",
                "capture_s", "graphs", "refine_steps", "events", "mean_abs_rel")})
        cut = tuple(v[:, :PROGRAM_PROFILE_FRAMES] if v.ndim > 3 else v for v in x)
        profiled = {}
        for dispatch in ("whole", "event"):
            pr = profile_batched(c, cut, dispatch)
            profiled[dispatch] = {k: pr[k] for k in (
                "events", "aggregate_steps_per_sec", "capture_s", "device_idle_share",
                "host_syncs_per_event", "host_launch_calls_per_event",
                "device_launches_per_event", "device_busy_ms", "wall_ms",
                "device_ms_by_family")}
        whole = [r["aggregate_steps_per_sec"] for r in timed_runs if r["dispatch"] == "whole"]
        event = [r["aggregate_steps_per_sec"] for r in timed_runs if r["dispatch"] == "event"]
        print(json.dumps({"phase": "batched_program", "phase_s": time.perf_counter() - t0,
                      "run": f"{name}_timed", "B": PROGRAM_B,
                          "frames": int(c.DEMO.sequence_length), "timed": timed_runs,
                          "speedup": sum(whole) / sum(event),
                          "profiled_frames": PROGRAM_PROFILE_FRAMES, "profiled": profiled,
                          "nvidia_smi": smi}), flush=True)
    # What an all-active graph without the selects would save, per step.
    for name, c in (("default", cfg), ("flagship", fcfg)):
        select_ms, kept = commit_select_ms(c, PROGRAM_B)
        print(json.dumps({"phase": "batched_program", "phase_s": time.perf_counter() - t0,
                          "run": f"{name}_commit_select", "B": PROGRAM_B,
                          "select_ms_a_step": select_ms, "bytes_kept": kept,
                          "bound_ms": 5 * kept / PEAK_BYTES * 1e3, "nvidia_smi": smi}),
              flush=True)
    return launches


# --- the online runner's observability outputs -------------------------------

OBS_FRAMES = 12
OBSERVED = {"VIZ__log_gradients": True, "DEBUG__plot": True, "DEBUG__plot_path": None}
OBS_KERNELS = ("knn_cand_kernel_dc", "knn_resident_kernel_dc")


def _log_steps(path):
    """A ScalarLogger JSONL's lines grouped by step: {step: {key: value}}."""
    steps = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            steps.setdefault(rec.pop("step"), {}).update(rec)
    return steps


def _trace_kernels(path, names):
    """How many kernel events of each of ``names`` (a prefix of the
    demangled name) a Chrome trace holds, and its event count."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {n: sum(k.startswith(n) for k in kernels) for n in names}, len(events)


def _frozen_parameters(cfg):
    """The network's parameters the engine freezes (batch norm's, with
    ``MODEL.refinement_mode``) and every parameter's name."""
    import torch

    from e2eslam_tpu_torch.models.depth_net import make_depth_model

    model = make_depth_model(cfg)
    frozen = {f"{mn}.{pn}" for mn, m in model.named_modules()
              if isinstance(m, torch.nn.BatchNorm2d)
              for pn, _ in m.named_parameters(recurse=False)} if cfg.MODEL.refinement_mode else set()
    return frozen, [n for n, _ in model.named_parameters()]


def _steps_per_sec(program, **settings):
    """One run of OBS_FRAMES frames of configs/config.yaml with the default
    algorithms and ``settings``, through the program or the loop: its
    steps/s, and its trace's size in bytes (None without one)."""
    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    cfg = load_yaml(default_config_path())
    cfg.DEMO.sequence_length = OBS_FRAMES
    for key, value in settings.items():
        sec, flag = key.split("__")
        cfg[sec][flag] = value
    runner = OnlineAdaptation(cfg)
    runner.use_sequence_program = program
    result = runner.run(verbose=False)
    if result["sequence_program"] != program:
        fail(f"observability: a timed run took the {'loop' if program else 'program'}")
    trace = result["profile_trace"]
    return result["steps_per_sec"], os.path.getsize(trace) if trace else None


def phase_observability(knn, smi):
    """The online runner's observability outputs (``SETTINGS.log_path``,
    ``VIZ.log_gradients``, ``DEBUG.plot``, ``VIZ.profile_dir``,
    ``VIZ.plot_final_step``) on OBS_FRAMES frames of configs/config.yaml at
    320x256: the observed run takes the program, as the JAX runner's does
    (the checks of the docstring's phase 14). Returns the observed
    program's device launches per kernel (eager launches plus captured ones
    times replays)."""
    import glob

    from e2eslam_tpu_torch.apps import online_adaption
    from e2eslam_tpu_torch.config import default_config_path, load_yaml

    t0 = time.perf_counter()
    base = os.path.join(OUT_DIR, "observability")
    log_dir, trace_dir, map_dir = (os.path.join(base, d) for d in ("log", "trace", "map"))
    # As it ships: the observed program, logged and traced, against the
    # observed loop.
    prog, pline = _sequence_run(knn, "config", OBS_FRAMES, True, sync_warn=True,
                                SETTINGS__log_path=log_dir, VIZ__profile_dir=trace_dir,
                                **OBSERVED)
    loop, lline = _sequence_run(knn, "config", OBS_FRAMES, False, **OBSERVED)
    gaps = _check_pair("observed_12", prog, loop, pline, lline, False)
    cfg = load_yaml(default_config_path())
    frozen, names = _frozen_parameters(cfg)
    steps = _log_steps(os.path.join(log_dir, f"{cfg.SETTINGS.name}.jsonl"))
    scalars = [k for k, v in prog["metrics"][0].items() if not isinstance(v, dict)]
    wanted = set(scalars) | {f"grad_norm/{n}" for n in names}
    bad_steps = [i for i, rec in steps.items()
                 if not wanted <= set(rec) or not all(map(_finite, rec.values()))]
    nonzero_frozen = [n for rec in steps.values() for n in frozen if rec[f"grad_norm/{n}"] != 0.0]
    counts, trace_events = _trace_kernels(prog["profile_trace"], OBS_KERNELS)
    print(json.dumps({"phase": "observability", "phase_s": time.perf_counter() - t0,
                      "run": "observed_12", "program": pline, "loop": lline, "gaps": gaps,
                      "log_steps": len(steps), "log_keys": len(wanted),
                      "trace_bytes": os.path.getsize(prog["profile_trace"]),
                      "trace_events": trace_events, "trace_kernels": counts,
                      "launches": pline["launches"], "nvidia_smi": smi}), flush=True)
    if pline["host_syncs_from_event_1"] != 0:
        fail(f"observability: the observed program synchronised "
             f"{pline['host_syncs_from_event_1']} times from event 1 to its end")
    if sorted(steps) != list(range(prog["num_keyframes"])) or bad_steps or nonzero_frozen:
        fail(f"observability: the scalar log has steps {sorted(steps)}, incomplete or "
             f"non-finite steps {bad_steps}, frozen norms not 0 {nonzero_frozen[:4]}")
    if not all(counts.values()):
        fail(f"observability: the trace holds kernels {counts}")

    # Seedless with the fused Adam: the program's norms and images are the
    # loop's, to the bit.
    fused = {**OBSERVED, "OPTIMIZATION__fused_update": True}
    sp, spl = _sequence_run(knn, "config", OBS_FRAMES, True, seedless=True, **fused)
    sl, sll = _sequence_run(knn, "config", OBS_FRAMES, False, seedless=True, **fused)
    equal = {k: _metrics_equal([m[k] for m in sp["metrics"]], [m[k] for m in sl["metrics"]])
             for k in ("grad_norms", "debug_images")}
    print(json.dumps({"phase": "observability", "phase_s": time.perf_counter() - t0,
                      "run": "observed_12_seedless_fused", "bitwise_equal": equal,
                      "gaps": _check_pair("observed_12_seedless_fused", sp, sl, spl, sll, True),
                      "nvidia_smi": smi}), flush=True)
    if not all(equal.values()):
        fail(f"observability: the seedless program's outputs part from the loop's: {equal}")

    # Timed with the default algorithms (printed, not checked).
    timed = {"observed_program": _steps_per_sec(True, **OBSERVED),
             "program": _steps_per_sec(True),
             "observed_loop": _steps_per_sec(False, **OBSERVED),
             "traced_observed_program": _steps_per_sec(
                 True, VIZ__profile_dir=os.path.join(base, "timed_trace"), **OBSERVED)}
    print(json.dumps({"phase": "observability", "phase_s": time.perf_counter() - t0,
                      "run": "timed", "frames": OBS_FRAMES,
                      "steps_per_sec": {k: v[0] for k, v in timed.items()},
                      "trace_bytes": timed["traced_observed_program"][1],
                      "nvidia_smi": smi}), flush=True)

    # The CLI's final map.
    result = online_adaption.main([
        "--config_path", default_config_path(), "--name", "observability",
        "--set", f"DEMO.sequence_length={OBS_FRAMES}", "--set", "DEBUG.print_metrics=false",
        "--set", "VIZ.plot_final_step=true", "--set", f"DEBUG.plot_path={map_dir}"])
    plys = glob.glob(os.path.join(map_dir, "*.ply"))
    with open(os.path.join(map_dir, "observability_map.ply")) as f:
        vertices = int([next(f) for _ in range(3)][2].split()[-1])
    print(json.dumps({"phase": "observability", "phase_s": time.perf_counter() - t0,
                      "run": "cli_final_map", "map_points": result["map_points"],
                      "ply_vertices": vertices, "files": [os.path.basename(x) for x in plys],
                      "nvidia_smi": smi}), flush=True)
    if vertices != min(result["map_points"], 200_000):
        fail(f"observability: the PLY has {vertices} vertices for {result['map_points']} "
             "map points")
    return pline["launches"]


OFFLINE_REPEATABLE = {"scale": phase_scale, "scaling_tools": phase_scaling_tools}


def small_repeats(n, names, knn=None, smi=None):
    """``phase_small`` ``n`` times per config (or ``phase_scale``,
    ``phase_scaling_tools`` for ``scale``, ``scaling_tools``), measuring
    only: the widest gap of each kind over the runs (the data of the bf16,
    SCALE_TOL and the other tolerances)."""
    for name in names:
        if name in OFFLINE_REPEATABLE:
            runs = [OFFLINE_REPEATABLE[name](knn, smi, check=False) for _ in range(n)]
        else:
            runs = [phase_small(name, check=False) for _ in range(n)]
        widest = {key: max(r[key] for r in runs) for key in runs[0]}
        print(json.dumps({"phase": "small_repeats", "config": name, "runs": n,
                          "widest_gaps": widest}), flush=True)


def run_phases(knn, names, smi):
    """Only the named phases (``fusion``, ``icl``, ``compact``, ``train_depth``,
    ``oft``, ``scale``, ``scaling_tools``, ``recover``, ``demo``, ``batched``,
    ``sharded``, ``sequence``, ``optimizers``, ``batched_program``,
    ``observability``, ``small:CONFIG``),
    each checked as in the full run; no kernels line and no result line."""
    stats = {}
    offline = {"train_depth": lambda: phase_train_depth(knn, stats, smi),
               "oft": lambda: phase_oft(knn, stats, smi),
               "scale": lambda: phase_scale(knn, smi),
               "scaling_tools": lambda: phase_scaling_tools(knn, smi),
               "recover": lambda: phase_recover(knn, stats, smi),
               "demo": lambda: phase_demo(knn, smi)}
    for name in names:
        if name == "fusion":
            phase_fusion()
        elif name == "batched":
            phase_batched(knn, stats, smi)
        elif name == "sharded":
            phase_sharded(knn, stats)
        elif name == "sequence":
            phase_sequence(knn, stats, smi)
        elif name == "batched_program":
            phase_batched_program(knn, stats, smi)
        elif name == "optimizers":
            phase_optimizers(smi)
        elif name == "observability":
            phase_observability(knn, smi)
        elif name == "icl":
            phase_icl(knn, stats, smi)
        elif name == "compact":
            phase_compact(knn, stats, smi, None)
        elif name in offline:
            offline[name]()
        elif name.startswith("small:"):
            phase_small(name.split(":", 1)[1])
        else:
            fail(f"unknown phase {name!r}")
    print(json.dumps({"phase": "phases_done", "phases": names}), flush=True)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "one CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "e2eslam_tpu_torch")):
        print("chip_smoke: e2eslam_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t0 = time.perf_counter()
    repeats = only = batched_n = None
    if argv and argv[0] == "--small-repeats":
        repeats, names = int(argv[1]), argv[2:] or list(SMALL_CONFIGS)
    elif argv and argv[0] == "--batched-repeats":
        batched_n = int(argv[1])
    elif argv and argv[0] == "--phases":
        only = argv[1:]

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"phase": "device", "name": name, "count": torch.cuda.device_count(),
                      "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)

    # 2. build
    from e2eslam_tpu_torch.ops import cuda_build

    build_s = cuda_build.build()
    print(json.dumps({"phase": "build", "seconds": build_s}), flush=True)
    for src in cuda_build.SOURCES:
        with open(cuda_build.library_path(src) + ".log") as f:
            for ln in f:
                if "registers" in ln or "spill" in ln:
                    print(f"ptxas[{src}]: {ln.strip()}", flush=True)

    import e2eslam_tpu_torch.ops.knn as knn
    from e2eslam_tpu_torch.device import set_full_fp32
    from e2eslam_tpu_torch.ops import spatial_sort

    set_full_fp32()
    try:
        if repeats is not None:
            small_repeats(repeats, names, knn, smi)
            return 0
        if batched_n is not None:
            batched_repeats(batched_n, knn)
            return 0
        if only is not None:
            run_phases(knn, only, smi)
            return 0
        return _all_phases(knn, spatial_sort, smi, name, t0)
    finally:
        shutil.rmtree(OUT_DIR, ignore_errors=True)


def _all_phases(knn, spatial_sort, smi, name, t0) -> int:
    import torch

    stats = {}
    # 3. kernels
    phase_kernels(knn, spatial_sort, stats)
    # 4. scatter fusion at default-seq60's shapes, then the main path
    _, fusion_stats = phase_fusion()
    launches, main = phase_main(knn, stats)
    # 5. the exact chamfer at map scale
    chamfer_launches, _ = phase_chamfer(knn, stats)
    # 6. the loss family, two networks
    losses_launches = phase_losses(knn, stats)
    # 7. the flagship configuration, then fusion's determinism
    flagship_launches, flagship_runs = phase_flagship(knn, smi)
    # 8. estimated odometry: the gradicp row, the brute path, view synthesis
    gradicp_launches = phase_gradicp(knn, smi)
    odom_brute_launches = phase_odom_brute(knn, stats)
    est_pose_launches = phase_est_pose(knn, stats)
    # 9. the projective, voxel and active-window associations
    assoc_launches = phase_assoc(knn, stats)
    # 10. a sequence from disk with trained weights in and out; compaction
    icl_launches = phase_icl(knn, stats, smi)
    compact_launches = phase_compact(knn, stats, smi, flagship_runs)
    # 11. the offline apps: train_depth, OFT, SCALE, the scaling tools, the
    # gradient-flow recovery (the dense kernel's path), the demo
    train_depth_launches = phase_train_depth(knn, stats, smi)
    oft_launches = phase_oft(knn, stats, smi)
    phase_scale(knn, smi)
    phase_scaling_tools(knn, smi)
    recover_launches = phase_recover(knn, stats, smi)
    phase_demo(knn, smi)
    # 12. several sequences at once on the card; the map-sharded search
    batched_launches = phase_batched(knn, stats, smi)
    sharded_launches = phase_sharded(knn, stats)
    # 13. the optimizers' formula; the whole-sequence program against the
    # loop; the program over B sequences against the per-event loop
    phase_optimizers(smi)
    sequence_launches = phase_sequence(knn, stats, smi)
    batched_program_launches = phase_batched_program(knn, stats, smi)
    # 14. the online runner's observability outputs through the program
    observability_launches = phase_observability(knn, smi)
    # 15. small input, card vs CPU
    for config in SMALL_CONFIGS:
        phase_small(config)

    kernels = []
    rows = [(key, key, "main path", launches[key]) for key in KERNEL_INFO]
    rows.append(("resident", "resident_ba", "chamfer b->a", stats["resident_ba"]["launches"]))
    rows.append(("dense", "dense_recover", "recover cold", recover_launches["dense"]))
    rows.append(("dense", "dense_sharded", "sharded shard", sharded_launches["dense"]))
    for key, st_key, call, n in rows:
        # Times come from the largest call of the kernel on its path; a
        # kernel the main path did not launch keeps its main-path-like
        # phase-3 time.
        kname, replaces = KERNEL_INFO[key]
        st = stats[st_key]
        kernels.append({"name": kname, "call": call, "route": "cuda", "source": SOURCE,
                        "replaces": replaces, "launches": n,
                        "chamfer_launches": chamfer_launches[key],
                        "losses_launches": losses_launches[key],
                        "flagship_launches": flagship_launches[key],
                        "gradicp_launches": gradicp_launches[key],
                        "odom_brute_launches": odom_brute_launches[key],
                        "est_pose_launches": est_pose_launches[key],
                        "assoc_launches": assoc_launches[key],
                        "icl_launches": icl_launches[key],
                        "compact_launches": compact_launches[key],
                        "train_depth_launches": train_depth_launches[key],
                        "oft_launches": oft_launches[key],
                        "recover_launches": recover_launches[key],
                        "batched_launches": batched_launches[key],
                        "sharded_launches": sharded_launches[key],
                        "sequence_launches": sequence_launches[key],
                        "batched_program_launches": batched_program_launches[key],
                        "observability_launches": observability_launches[key],
                        "max_abs_err": st.get("max_abs_err"), "ms": st.get("ms"),
                        "kernel_ms": st.get("kernel_ms"),
                        "plain_ms": st.get("plain_ms"), "bound_ms": st.get("bound_ms"),
                        "bound_by": st.get("bound_by"), "library_ms": None,
                        "call_ms": st.get("call_ms"), "visited_pairs": st.get("visited_pairs"),
                        "repeated_pairs": st.get("repeated_pairs"),
                        "visit_max": st.get("visit_max"), "visit_mean": st.get("visit_mean"),
                        "check_launches": st.get("check_launches", 0),
                        "cdist_ms": st.get("cdist_ms")})
    for st in fusion_stats:
        kernels.append({"name": "pointfusion", "call": f"fusion of {st['count']} rows",
                        "route": "cuda", "source": "e2eslam_tpu_torch/ops/csrc/pointfusion.cu",
                        "replaces": None, "launches": main["fusion_launches"],
                        "ms": st["pass_ms"], "kernel_ms": st["kernel_ms"],
                        "plain_ms": st["plain_pass_ms"], "bound_ms": st["bound_ms"],
                        "bound_by": "bytes", "call_ms": st["pass_call_ms"]})
    print(json.dumps({"phase": "done", "seconds": time.perf_counter() - t0}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
