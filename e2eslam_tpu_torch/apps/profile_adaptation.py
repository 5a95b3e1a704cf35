"""Measure online adaptation on one CUDA card: steps/s, quality, where the time goes.

    python -m e2eslam_tpu_torch.apps.profile_adaptation \\
        [--config_path configs/config.yaml]
        [--workload config|chamfer|flagship|gradicp|compact|icl|batched]
        [--set SECTION.key=value ...] [--runs 1] [--deterministic]
        [--profile_frames 12] [--loop keyframe|sequence ...] [--n_seq 1 2 4]
        [--dispatch whole|event ...] [--out DIR]

Three runs of the config's main path, each on a fresh runner with the same
seeded weights, after the kernels are built, for each way of running it
that ``--loop`` names (default: the runner's own choice): ``sequence`` the
whole-sequence program (``use_sequence_program`` on; on the card its warm
events replay one CUDA graph), ``keyframe`` the per-keyframe loop
(``use_sequence_program`` off); two ways alternate, run by run:
  1. a warm-up of 4 frames (cuDNN heuristics, allocator, kernel loading);
  2. the config as it stands (``DEMO.sequence_length`` frames), ``--runs``
     times, each timed with a synchronised host clock: steps/s, mean
     abs_rel, map points, the loop's KNN launches (the spread of identical
     runs; ``--deterministic``: with deterministic algorithms and cuDNN,
     whose runs repeat); with the program, also steps/s without the
     capture time (``steps_per_sec_no_capture``);
  3. ``--profile_frames`` frames (at most the workload's own) under
     ``torch.profiler``: device time by kernel family (the KNN kernels and
     the convolutions; every other kernel is shared by several layers),
     the program's own phase times per replayed event from its device
     timestamps (``utils/tracing.py``: the sort, each step's phases,
     fusion), the device's launches
     (kernels and copies), its idle share (1 - the union of its kernel and
     copy intervals over the adaptation's ranges, profiler overhead
     included),
     the host's launch calls and the device's kernels per keyframe event,
     and the host synchronisations per event
     (``torch.cuda.set_sync_debug_mode("warn")`` over the profiled run, as
     ``chip_smoke.py::host_syncs_per_event`` counts them).
``--workload chamfer`` applies tools/bench_exact.py's TUM chamfer row to
the config (``chamfer_config``), ``--workload flagship`` the JAX package's
benchmark configuration (``flagship_config``: index fusion and
association, the bf16 CNN, the fused Adam), ``--workload gradicp`` its
trajectory row (``gradicp_config``: the same with gradICP odometry; the
run's ATE and RPE are reported too), ``--workload compact`` the flagship
with live-map compaction (``compact_config``, tools/bench_flagship_compact.py:
every 10th keyframe, projective), ``--workload icl`` the ICL-NUIM
configuration (configs/config_icl_online.yaml, whatever ``--config_path``
says) on the repository's 10-frame sequence, its network loaded from a
``depth.pth.tar`` of seeded weights written to a temporary directory
(``icl_config``). Prints one JSON object per
run; with ``--out DIR`` also writes them to ``DIR/profile.json``.
``--set`` overrides a setting after the workload's (a YAML value, e.g.
``--set SETTINGS.compute_dtype=float32``).

``--workload batched`` is the port's copy of tools/bench_batched.py: B
sequences adapting at once on the card (``parallel/adaptation.py``, the
depth networks of all B in one vmapped call), the flagship settings
(``flagship_config``), B distinct synthetic sequences with staggered
starts (``make_sequences``: ragged schedules). For each B of ``--n_seq`` and
each ``--dispatch`` (default ``event``, the per-event loop; ``whole`` the
program over the B sequences, its warm events one CUDA graph's replays):
a warm-up over each sequence's first 4 frames, then ``--runs`` timed runs,
each printing the aggregate steps/s (every sequence's refinement steps
over the synchronised wall clock of the run), the graphs captured and
``capture_s``, each sequence's keyframes, mean abs_rel and map points, and
the card's name and power limit; then ``--profile_frames`` frames of each
dispatch under the profiler, as step 3 above (``profile_batched``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile

import torch

import numpy as np

from e2eslam_tpu_torch.config import apply_overrides, default_config_path, load_yaml
from e2eslam_tpu_torch.data.synthetic import SyntheticDataset
from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation
from e2eslam_tpu_torch.models.convert import save_reference_checkpoint
from e2eslam_tpu_torch.models.depth_net import make_depth_model
from e2eslam_tpu_torch.ops import cuda_build
from e2eslam_tpu_torch.ops import knn as knn_ops
from e2eslam_tpu_torch.parallel.adaptation import ParallelAdaptation
from e2eslam_tpu_torch.utils import tracing

# (family, substrings of CUDA kernel names), first match wins: the kernels
# only one layer launches. The rest (matmuls, sorts, gathers, reductions,
# elementwise) serve several; the program's phase times place them.
FAMILIES = (
    ("knn kernels", ("knn_",)),
    ("fusion kernels", ("pointfusion_",)),
    ("convolutions (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad",
                              "fprop", "winograd", "cutlass")),
)


def _family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def chamfer_config(cfg):
    """tools/bench_exact.py's TUM chamfer row (:134-144) on its base config
    (:35-50): 40 frames at dilation 5, keyframes 0.12 m apart, three3d off,
    the exact bidirectional chamfer on, brute KNN at strides 1/1, scatter
    fusion, 3 refine steps, the median over every 4th pixel. In float32
    with the per-tensor Adam, where the row runs the bf16 network and the
    fused update (``--set`` applies them), so its numbers compare with the
    cell's earlier runs."""
    cfg.DATA.name = "synthetic"
    cfg.DATA.start = 0
    cfg.DATA.dilation = 5
    cfg.DEMO.sequence_length = 40
    cfg.DEMO.frame_threshold = 0.12
    cfg.OPTIMIZATION.refinement_steps = 3
    cfg.MODEL.fusion_impl = "scatter"
    cfg.LOSS.knn_impl = "brute"
    cfg.LOSS.three3d_query_stride = 1
    cfg.LOSS.three3d_map_stride = 1
    cfg.LOSS.three3d_loss = False
    cfg.LOSS.chamfer_distance = True
    cfg.ABLATION.median_stride = 4
    return cfg


def flagship_config(cfg):
    """The JAX package's benchmark configuration, ``bench.py:67-127``
    (``flagship_cfg``; its own copy, since bench.py imports JAX): 60
    synthetic frames at 320x256, dilation 2, keyframes 0.03 m apart, 3 PFT
    steps; three3d through the index image (fusion and association, query
    stride 1, association on level 1 of two index levels, no search
    radius), relative alignment, a 0.15 m distance gate, confidence
    weights, weight 0.1; the bf16 CNN, the fused Adam and the median over
    every 4th pixel."""
    cfg.DATA.name = "synthetic"
    cfg.DATA.height, cfg.DATA.width = 256, 320
    cfg.DATA.start = 0
    cfg.DATA.dilation = 2
    cfg.DEMO.sequence_length = 60
    cfg.DEMO.frame_threshold = 0.03
    cfg.OPTIMIZATION.refinement_steps = 3
    cfg.LOSS.three3d_loss = True
    cfg.MODEL.fusion_impl = "index"
    cfg.LOSS.knn_impl = "index"
    cfg.LOSS.three3d_query_stride = 1
    cfg.LOSS.three3d_align = "relative"
    cfg.LOSS.three3d_dist_gate = 0.15
    cfg.LOSS.three3d_conf_weight = True
    cfg.LOSS.three3d_loss_weight = 0.1
    cfg.SETTINGS.compute_dtype = "bfloat16"
    cfg.MODEL.index_search_radius = 0
    cfg.MODEL.index_levels = 2
    cfg.LOSS.index_assoc_levels = 1
    cfg.OPTIMIZATION.fused_update = True
    cfg.ABLATION.median_stride = 4
    return cfg


def gradicp_config(cfg):
    """The JAX package's trajectory row, ``bench.py:161-176``: the flagship
    configuration with the reference's default odometry, ``MODEL.odom:
    gradicp`` (20 iterations, every 4th pixel, 0.2 m gate). View synthesis
    keeps the dataset's poses; each keyframe is fused at its gradICP
    estimate, anchored to the previous keyframe's dataset pose."""
    cfg = flagship_config(cfg)
    cfg.MODEL.odom = "gradicp"
    return cfg


def compact_config(cfg):
    """The JAX package's flagship-with-compaction row
    (tools/bench_flagship_compact.py:31-35): ``flagship_config`` with a
    projective compaction pass after every 10th fused keyframe."""
    cfg = flagship_config(cfg)
    cfg.MODEL.compact_period = 10
    cfg.MODEL.compact_mode = "projective"
    return cfg


ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ICL_CONFIG = os.path.join(ROOT, "configs", "config_icl_online.yaml")
MINI_ICL_ROOT = os.path.join(ROOT, "tests", "data")  # holds ICL/living_room_traj0_frei_png


def icl_config(weights_dir=None):
    """The reference's ICL-NUIM online configuration
    (configs/config_icl_online.yaml: ResNet-18 indoor at 320x256, brute
    three3d, Adam with StepLR, the network from ``load_depth_path``) on the
    repository's 10-frame ICL-format sequence (640x480 PNGs; synthetic
    content, tools/make_mini_icl.py). Cut to it: ``DATA.data_path`` the
    repository's ``tests/data``, ``DEMO.sequence_length`` 10, ``dilation``
    0, ``stride`` 1, ``frame_threshold`` 0.01. ``weights_dir`` holds the
    ``depth.pth.tar`` to load (the published ``extras/indoor`` is not in the
    repository)."""
    cfg = load_yaml(ICL_CONFIG)
    cfg.DATA.data_path = MINI_ICL_ROOT
    cfg.DEMO.sequence_length = 10
    cfg.DATA.dilation = 0
    cfg.DATA.stride = 1
    cfg.DEMO.frame_threshold = 0.01
    if weights_dir is not None:
        cfg.MODEL.load_depth_path = weights_dir
    return cfg


def seeded_weights_dir(cfg, dirpath, seed=0):
    """``dirpath`` with a ``depth.pth.tar`` of the seeded network
    (``make_depth_model(cfg, seed=seed)``) in the reference's layout."""
    save_reference_checkpoint(make_depth_model(cfg, seed=seed), dirpath)
    return dirpath


WORKLOADS = {"config": lambda cfg: cfg, "chamfer": chamfer_config,
             "flagship": flagship_config, "gradicp": gradicp_config,
             "compact": compact_config, "icl": lambda cfg: icl_config(),
             "batched": flagship_config}


def make_sequences(b, seq_len, h, w, dilation=2):
    """``b`` distinct synthetic sequences of ``seq_len`` frames, sequence
    ``i`` starting at frame ``7 i`` (tools/bench_batched.py:41-59): their
    keyframe schedules differ. Returns (colors [b, L, h, w, 3] in [0, 1],
    depths [b, L, h, w, 1], intrinsics [b, 4, 4], poses [b, L, 4, 4]) as
    numpy arrays."""
    colors, depths, intr, poses = [], [], [], []
    for i in range(b):
        ds = SyntheticDataset(seqlen=seq_len, height=h, width=w, dilation=dilation,
                              start=7 * i, total_frames=3 * seq_len + 7 * b + 4)
        c, d, K, p, _ = ds[0]
        colors.append(c.astype(np.float32) / 255.0)
        depths.append(d)
        intr.append(K)
        poses.append(p)
    return np.stack(colors), np.stack(depths), np.stack(intr), np.stack(poses)


def run_batched(cfg, sequences, weights=None, dispatch="event", runner_hook=None):
    """One ``ParallelAdaptation`` run of ``sequences`` on the card with the
    seeded network (or ``weights``) through ``dispatch``, the per-event
    loop's launches counted (the wrappers' counter misses the program's
    replays); ``runner_hook(par)`` sees the runner before it runs. Returns
    (the run's line, the runner's result)."""
    b, L, h, w = sequences[0].shape[:4]
    for k in knn_ops.KERNELS:
        k.launches = 0
    model = make_depth_model(cfg)
    par = ParallelAdaptation(cfg, model, map_capacity=L * h * w, n_seq=b)
    if runner_hook is not None:
        runner_hook(par)
    out = par.run(par.init_state(weights), sequences,
                  threshold=float(cfg.DEMO.frame_threshold), dispatch=dispatch)
    seqs = out["per_sequence"]
    busy = out["elapsed_s"] - out["capture_s"]
    line = {"B": b, "frames": L, "dispatch": out["dispatch"], "events": out["num_events"],
            "refine_steps": out["refine_steps"], "elapsed_s": out["elapsed_s"],
            "aggregate_steps_per_sec": out["steps_per_sec"],
            "graphs": out["graphs"], "capture_s": out["capture_s"],
            "steps_per_sec_no_capture": out["refine_steps"] / busy if busy > 0 else 0.0,
            "keyframes": [r["num_keyframes"] for r in seqs],
            "mean_abs_rel": [r["mean_abs_rel"] for r in seqs],
            "map_points": [r["map_points"] for r in seqs]}
    if out["dispatch"] != "whole":
        line["launches"] = {k.__name__: k.launches for k in knn_ops.KERNELS}
    if out["trace"] is not None:
        line["trace"] = out["trace"]
    return line, out


def _batched(args, out, smi):
    cfg = _config(args.config_path, "batched", None, args.set)
    h, w, L = int(cfg.DATA.height), int(cfg.DATA.width), int(cfg.DEMO.sequence_length)
    out["batched"], out["profiled"] = [], []
    for b in args.n_seq:
        seqs = make_sequences(b, L, h, w)
        for dispatch in args.dispatch:  # warm-up
            run_batched(cfg, tuple(x[:, :4] if x.ndim > 3 else x for x in seqs),
                        dispatch=dispatch)
        for _ in range(args.runs):
            for dispatch in args.dispatch:
                torch.cuda.reset_peak_memory_stats()
                line, _ = run_batched(cfg, seqs, dispatch=dispatch)
                line.update(peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                            nvidia_smi=smi)
                out["batched"].append(line)
                print(json.dumps({"batched": line}), flush=True)
        cut = tuple(x[:, :args.profile_frames] if x.ndim > 3 else x for x in seqs)
        for dispatch in args.dispatch:
            profiled = profile_batched(cfg, cut, dispatch)
            out["profiled"].append(profiled)
            print(json.dumps({"profiled": profiled}), flush=True)
    return out


def _config(path, workload="config", frames=None, overrides=(), weights_dir=None):
    if workload == "icl":
        cfg = icl_config(weights_dir=weights_dir)
    else:
        cfg = WORKLOADS[workload](load_yaml(path))
    apply_overrides(cfg, overrides)
    if frames:
        cfg.DEMO.sequence_length = int(frames)
    return cfg


LOOPS = {"sequence": True, "keyframe": False}
# The CUDA runtime's launch calls, as the profiler names them.
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def _run(cfg, loop=None):
    for k in knn_ops.KERNELS:
        k.launches = 0
    runner = OnlineAdaptation(cfg)
    if loop is not None:
        runner.use_sequence_program = LOOPS[loop]
    result = runner.run(verbose=False)
    busy_s = result["elapsed_s"] - result["capture_s"]
    line = {
        "loop": loop,
        "sequence_program": result["sequence_program"],
        "graphs": result["graphs"],
        "capture_s": result["capture_s"],
        "steps_per_sec_no_capture": result["refine_steps"] / busy_s if busy_s > 0 else 0.0,
        "frames": int(cfg.DEMO.sequence_length),
        "keyframes": result["num_keyframes"],
        "refine_steps": result["refine_steps"],
        "elapsed_s": result["elapsed_s"],
        "steps_per_sec": result["steps_per_sec"],
        "mean_abs_rel": result["mean_abs_rel"],
        "map_points": result["map_points"],
        "ate": result["ate"],
        "rpe": result["rpe"],
        "compactions": result["compactions"],
    }
    if not result["sequence_program"]:  # the wrappers' counter misses the replays
        line["launches"] = {k.__name__: k.launches for k in knn_ops.KERNELS}
    if result["trace"] is not None:
        line["trace"] = result["trace"]
    return line


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config_path", default=default_config_path())
    p.add_argument("--workload", choices=sorted(WORKLOADS), default="config")
    p.add_argument("--set", action="append", default=[], metavar="SECTION.key=value")
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--profile_frames", type=int, default=12)
    p.add_argument("--loop", choices=sorted(LOOPS), nargs="+", default=[None])
    p.add_argument("--n_seq", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--dispatch", choices=("whole", "event"), nargs="+", default=["event"])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_adaptation measures the card: no CUDA device found")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    if args.deterministic:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        torch.use_deterministic_algorithms(True, warn_only=True)
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "workload": args.workload, "set": args.set, "deterministic": args.deterministic,
           "build_s": cuda_build.build()}
    print(json.dumps(out), flush=True)
    if args.workload == "batched":
        out = _batched(args, out, smi)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "profile.json"), "w") as f:
                json.dump(out, f, indent=1)
        return out

    tmp = tempfile.TemporaryDirectory()
    weights = None
    if args.workload == "icl":
        weights = seeded_weights_dir(icl_config(), tmp.name)

    def config(frames=None):
        return _config(args.config_path, args.workload, frames, args.set, weights)

    for loop in args.loop:
        _run(config(4), loop)  # warm-up
    out["timed"] = []
    for _ in range(args.runs):
        for loop in args.loop:
            torch.cuda.reset_peak_memory_stats()
            timed = _run(config(), loop)
            timed["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
            out["timed"].append(timed)
            print(json.dumps({"timed": timed}), flush=True)
    out["profiled"] = []
    for loop in args.loop:
        profiled = _profiled(config, args.profile_frames, loop)
        out["profiled"].append(profiled)
        print(json.dumps({"profiled": profiled}), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile.json"), "w") as f:
            json.dump(out, f, indent=1)
    return out


def _profiled(config, profile_frames, loop):
    """One run under ``torch.profiler`` and the sync-debug warnings: the
    device's time by kernel family, its idle share, launches and host
    synchronisations per keyframe event."""
    # At most the workload's own frames (the icl sequence holds 10).
    frames = min(profile_frames, int(config().DEMO.sequence_length))

    def run():
        cfg = config(frames)
        cfg.VIZ.profile_dir = None  # this profiler traces the run: two do not nest
        return _run(cfg, loop)

    return profiled_run(run, lambda r: r["keyframes"])


def profile_batched(cfg, sequences, dispatch):
    """``run_batched`` of ``sequences`` through ``dispatch`` under the
    profiler (``profiled_run``, device activity alone: B sequences' host
    operators would swell the trace), per keyframe event (the padded
    schedule's)."""
    return profiled_run(lambda: run_batched(cfg, sequences, dispatch=dispatch)[0],
                        lambda r: r["events"], host_ops=False)


def profiled_run(run, events_of, host_ops=True):
    """``run()`` (returning a line with ``elapsed_s``, its own synchronised
    clock over the adaptation alone, and the run's ``trace``) under
    ``torch.profiler`` (with the host's operators unless ``host_ops`` is
    off; the CUDA runtime's calls are traced either way) and the sync-debug
    warnings: the line with the device's time by kernel family, the
    program's phase times per replayed event (``phase_ms_per_event``), the
    marks' own device time (``timestamp_us_per_event``) and their clock
    against the profiler's (``stamp_clock_gap_us_max``), the device's idle
    share (1 - the union of its intervals over the adaptation's ranges:
    the program's, or the loop's events; over its first to last interval
    when the host is not traced), its launches (kernels and copies) and
    the host's launch calls and synchronisations per event
    (``events_of(line)`` events)."""
    import warnings

    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host_ops:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with torch.profiler.profile(activities=acts) as prof:
                profiled = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    trace = profiled.pop("trace", None)
    events = max(events_of(profiled), 1)
    fam, kernels = {}, []
    launches = 0
    host_launches = 0
    for evt in prof.key_averages():
        if evt.key in HOST_LAUNCHES:
            host_launches += evt.count
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if (not dev_us or evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False) or "#" in evt.key
                or evt.key.startswith(tracing.PREFIX)):
            continue  # annotations span kernels already counted
        launches += evt.count
        fam[_family(evt.key)] = fam.get(_family(evt.key), 0.0) + dev_us / 1e3
        kernels.append((dev_us / 1e3, evt.count, evt.key[:90]))
    kernels.sort(reverse=True)
    all_events = prof.events()
    device = tracing.device_intervals(all_events)
    ranges = [(e.time_range.start, e.time_range.end) for e in all_events
              if e.name.startswith(tracing.PREFIX) and not e.name.startswith(tracing.PREFIX + "unit.")
              and not str(e.device_type).endswith("CUDA")]
    span = ranges or [(s, e) for s, e, _ in device]
    lo, hi = min(s for s, _ in span), max(e for _, e in span)
    busy_us = tracing.union_length([(max(s, lo), min(e, hi)) for s, e, _ in device
                                    if e > lo and s < hi])
    stamps_us = sum(e - s for s, e, n in device if n == tracing.TIMESTAMP_KERNEL)
    gaps = tracing.stamp_clock_gaps_us(trace, device) if trace else []
    profiled.update({
        "wall_ms": profiled["elapsed_s"] * 1e3,
        "span_ms": (hi - lo) / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_launches": launches,
        "device_launches_per_event": launches / events,
        "host_launch_calls_per_event": host_launches / events,
        "host_syncs": syncs,
        "host_syncs_per_event": syncs / events,
        "device_idle_share": 1.0 - busy_us / (hi - lo) if hi > lo else None,
        "device_ms_by_family": dict(sorted(fam.items(), key=lambda kv: -kv[1])),
        "phase_ms_per_event": phase_ms_per_event(trace) if trace else None,
        "timestamp_us_per_event": stamps_us / events,
        "stamp_clock_gap_us_max": max((abs(g) for g in gaps), default=None),
        "top_kernels_ms_count": kernels[:15],
    })
    return profiled


def phase_ms_per_event(trace):
    """A run's ``trace``: each phase's mean ms over its replayed events (all
    its events where none replayed), the steps' phases summed over steps."""
    ms = np.asarray(trace["event_phase_ms"])
    if not len(ms):
        return {}
    rows = [e for e, r in enumerate(trace["replayed"]) if r] or list(range(len(ms)))
    out = {}
    for j, name in enumerate(trace["phases"]):
        base = name.split(".")[0]
        out[base] = out.get(base, 0.0) + float(ms[rows, j].mean())
    return out


if __name__ == "__main__":
    main()
