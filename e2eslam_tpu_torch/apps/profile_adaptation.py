"""Measure online adaptation on one CUDA card: steps/s, quality, where the time goes.

    python -m e2eslam_tpu_torch.apps.profile_adaptation \\
        [--config_path configs/config.yaml]
        [--workload config|chamfer|flagship|gradicp]
        [--set SECTION.key=value ...] [--runs 1] [--deterministic]
        [--profile_frames 12] [--out DIR]

Three runs of the config's main path, each on a fresh runner with the same
seeded weights, after the kernels are built:
  1. a warm-up of 4 frames (cuDNN heuristics, allocator, kernel loading);
  2. the config as it stands (``DEMO.sequence_length`` frames), ``--runs``
     times, each timed with a synchronised host clock: steps/s, mean
     abs_rel, map points, KNN launches (the spread of identical runs;
     ``--deterministic``: with deterministic algorithms and cuDNN, whose
     runs repeat);
  3. ``--profile_frames`` frames under ``torch.profiler``: device time by
     kernel family, the device's launches (kernels and copies), and the
     device's idle share over the adaptation loop (1 - kernel time / the
     run's own clock, profiler overhead included).
``--workload chamfer`` applies tools/bench_exact.py's TUM chamfer row to
the config (``chamfer_config``), ``--workload flagship`` the JAX package's
benchmark configuration (``flagship_config``: index fusion and
association, the bf16 CNN, the fused Adam), ``--workload gradicp`` its
trajectory row (``gradicp_config``: the same with gradICP odometry; the
run's ATE and RPE are reported too). Prints one JSON object per
run; with ``--out DIR`` also writes them to ``DIR/profile.json``.
``--set`` overrides a setting after the workload's (a YAML value, e.g.
``--set SETTINGS.compute_dtype=float32``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch
import yaml

from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation
from e2eslam_tpu_torch.ops import cuda_build
from e2eslam_tpu_torch.ops import knn as knn_ops

FAMILIES = (  # (family, substrings of CUDA kernel names), first match wins
    ("knn kernels", ("knn_",)),
    ("convolutions (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad",
                              "fprop", "winograd", "cutlass")),
    ("matmul", ("gemm",)),
    ("sort", ("sort", "radix")),
    ("scatter / gather / index", ("scatter", "gather", "index", "take")),
    ("reductions", ("reduce", "argmax", "argmin", "max_kernel", "min_kernel")),
)


def _family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "elementwise / other"


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


WORKLOADS = {"config": lambda cfg: cfg, "chamfer": chamfer_config,
             "flagship": flagship_config, "gradicp": gradicp_config}


def _config(path, workload="config", frames=None, overrides=()):
    cfg = WORKLOADS[workload](load_yaml(path))
    for item in overrides:
        key, value = item.split("=", 1)
        section, flag = key.split(".")
        cfg[section][flag] = yaml.safe_load(value)
    if frames:
        cfg.DEMO.sequence_length = int(frames)
    return cfg


def _run(cfg):
    for k in knn_ops.KERNELS:
        k.launches = 0
    result = OnlineAdaptation(cfg).run(verbose=False)
    return {
        "frames": int(cfg.DEMO.sequence_length),
        "keyframes": result["num_keyframes"],
        "refine_steps": result["refine_steps"],
        "elapsed_s": result["elapsed_s"],
        "steps_per_sec": result["steps_per_sec"],
        "mean_abs_rel": result["mean_abs_rel"],
        "map_points": result["map_points"],
        "ate": result["ate"],
        "rpe": result["rpe"],
        "launches": {k.__name__: k.launches for k in knn_ops.KERNELS},
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config_path", default=default_config_path())
    p.add_argument("--workload", choices=sorted(WORKLOADS), default="config")
    p.add_argument("--set", action="append", default=[], metavar="SECTION.key=value")
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--profile_frames", type=int, default=12)
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

    _run(_config(args.config_path, args.workload, 4, args.set))  # warm-up
    out["timed"] = []
    for _ in range(args.runs):
        torch.cuda.reset_peak_memory_stats()
        timed = _run(_config(args.config_path, args.workload, overrides=args.set))
        timed["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["timed"].append(timed)
        print(json.dumps({"timed": timed}), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled = _run(_config(args.config_path, args.workload, args.profile_frames, args.set))
    # The run's own clock starts after the runner is built and the frames
    # are rendered, so the idle share is over the adaptation loop alone.
    wall_ms = profiled["elapsed_s"] * 1e3
    fam, kernels = {}, []
    busy_us = 0.0
    launches = 0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if (not dev_us or evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False) or "#" in evt.key):
            continue  # annotations span kernels already counted
        busy_us += dev_us
        launches += evt.count
        fam[_family(evt.key)] = fam.get(_family(evt.key), 0.0) + dev_us / 1e3
        kernels.append((dev_us / 1e3, evt.count, evt.key[:90]))
    kernels.sort(reverse=True)
    profiled.update({
        "wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3,
        "device_launches": launches,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms if wall_ms else None,
        "device_ms_by_family": dict(sorted(fam.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms_count": kernels[:15],
    })
    out["profiled"] = profiled
    print(json.dumps({"profiled": profiled}), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile.json"), "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
