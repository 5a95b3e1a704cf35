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
  4. main     online adaptation from configs/config.yaml at full width
              (320x256, ResNet-18, 3 refine steps, brute three3d), only
              DEMO.sequence_length cut, with every kernel launch counted and
              the largest call of each kernel kept; those calls are then held
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
 11. small    the default path, the chamfer one, index fusion and
              association (float32), the flagship settings, gradICP, the
              voxel association, the ICL sequence and the compact workload
              at 64x64 on the card, with deterministic
              algorithms and with the default ones, and on the CPU (plain
              versions): the same keyframes, abs_rel and map size
              (``SMALL_CONFIGS``: float32 tolerances, and for bf16, gradICP
              and voxel twice the widest gaps of repeated card runs,
              ``python3 chip_smoke.py --small-repeats N [config ...]``, which
              runs only this phase, N times, and reports the gaps).
``python3 chip_smoke.py --phases icl compact small:icl ...`` runs only the
named phases (after the build), each with its checks, and prints neither
the kernels line nor the result.
The second-to-last line is the kernels' JSON line (the resident kernel has
a second entry, ``"call": "chamfer b->a"``, for its map->frame calls; each
entry counts its launches per path), the last line the result.
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
    nq = args[-3]
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


def phase_main(knn, stats):
    import torch

    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    cfg = load_yaml(default_config_path())
    cfg.DEMO.sequence_length = 12  # the only cut: ~10 keyframes
    runner = OnlineAdaptation(cfg)  # CUDA: the entry point's default
    for k in knn.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with Recorder(knn) as rec:
        result = runner.run(verbose=False)
    launches = launch_counts(knn)
    for i, (frame, m) in enumerate(zip(result["keyframes"], result["metrics"])):
        print(json.dumps({"phase": "main", "keyframe": i, "frame": frame,
                          "loss": m["total_loss"], "photometric": m["photometric"],
                          "three3d": m["three3d"], "abs_rel": m["abs_rel"]}), flush=True)
    summary = {"phase": "main", "keyframes": result["num_keyframes"],
               "refine_steps": result["refine_steps"], "map_points": result["map_points"],
               "mean_abs_rel": result["mean_abs_rel"], "elapsed_s": result["elapsed_s"],
               "steps_per_sec": result["steps_per_sec"],
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": launches, "capacity": runner.capacity}
    print(json.dumps(summary), flush=True)
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
    runner = OnlineAdaptation(cfg)
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
    route_options(knn, args, out[:2])
    return launches, summary


def route_options(knn, args, resident_out):
    """The candidate kernel on a resident call's inputs, with the table the
    dispatcher would build for it (ref tiles of RT_CAND rows whose box gap
    is below each query tile's seeded worst-best distance, best first): it
    must give the resident kernel's scores bit for bit. Both wrappers timed
    with CUDA events (median of 5 over 3 back-to-back calls); the table's
    build is timed apart. Run after the path's launch counts are read."""
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
            "table_entries": int(counts.sum()), "table_width": int(order.shape[1])}
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
        runner = OnlineAdaptation(cfg)
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
    OnlineAdaptation(warm).run(verbose=False)

    def run(deterministic):
        runner = OnlineAdaptation(flagship_config(load_yaml(default_config_path())))
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
    OnlineAdaptation(warm).run(verbose=False)
    print(json.dumps({"phase": "gradicp", "reference": JAX_GRADICP_ROW}), flush=True)
    total = dict.fromkeys(KERNEL_INFO, 0)
    for deterministic in (False, True):
        runner = OnlineAdaptation(gradicp_config(load_yaml(default_config_path())))
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
    runner = OnlineAdaptation(cfg)
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
    probe = OnlineAdaptation(cfg)
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
        runner = OnlineAdaptation(cfg)
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
        fresh = OnlineAdaptation(restored)
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

    runner = OnlineAdaptation(compact_config(load_yaml(default_config_path())))
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
    runner = OnlineAdaptation(cfg)
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
        return OnlineAdaptation(setup(cfg), device=device).run(verbose=False)

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


def small_repeats(n, names):
    """``phase_small`` ``n`` times per config, measuring only: the widest
    gap of each kind over the runs (the data of the bf16 tolerances)."""
    for name in names:
        runs = [phase_small(name, check=False) for _ in range(n)]
        widest = {key: max(r[key] for r in runs) for key in runs[0]}
        print(json.dumps({"phase": "small_repeats", "config": name, "runs": n,
                          "widest_gaps": widest}), flush=True)


def run_phases(knn, names, smi):
    """Only the named phases (``icl``, ``compact``, ``small:CONFIG``), each
    checked as in the full run; no kernels line and no result line."""
    stats = {}
    for name in names:
        if name == "icl":
            phase_icl(knn, stats, smi)
        elif name == "compact":
            phase_compact(knn, stats, smi, None)
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
    repeats = only = None
    if argv and argv[0] == "--small-repeats":
        repeats, names = int(argv[1]), argv[2:] or list(SMALL_CONFIGS)
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
    if repeats is not None:
        small_repeats(repeats, names)
        return 0
    if only is not None:
        run_phases(knn, only, smi)
        return 0
    stats = {}
    # 3. kernels
    phase_kernels(knn, spatial_sort, stats)
    # 4. main path
    launches, _ = phase_main(knn, stats)
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
    # 11. small input, card vs CPU
    for config in SMALL_CONFIGS:
        phase_small(config)

    kernels = []
    rows = [(key, key, "main path", launches[key]) for key in KERNEL_INFO]
    rows.append(("resident", "resident_ba", "chamfer b->a", stats["resident_ba"]["launches"]))
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
                        "max_abs_err": st.get("max_abs_err"), "ms": st.get("ms"),
                        "kernel_ms": st.get("kernel_ms"),
                        "plain_ms": st.get("plain_ms"), "bound_ms": st.get("bound_ms"),
                        "bound_by": st.get("bound_by"), "library_ms": None,
                        "call_ms": st.get("call_ms"), "visited_pairs": st.get("visited_pairs"),
                        "repeated_pairs": st.get("repeated_pairs"),
                        "visit_max": st.get("visit_max"), "visit_mean": st.get("visit_mean"),
                        "check_launches": st.get("check_launches", 0),
                        "cdist_ms": st.get("cdist_ms")})
    print(json.dumps({"phase": "done", "seconds": time.perf_counter() - t0}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
