"""Measure online adaptation on one CUDA card: steps/s, quality, where the time goes.

    python -m e2eslam_tpu_torch.apps.profile_adaptation \\
        [--config_path configs/config.yaml] [--profile_frames 12] [--out DIR]

Three runs of the config's main path, each on a fresh runner with the same
seeded weights, after the kernels are built:
  1. a warm-up of 4 frames (cuDNN heuristics, allocator, kernel loading);
  2. the config as it stands (``DEMO.sequence_length`` frames), timed with a
     synchronised host clock: steps/s, mean abs_rel, map points, KNN launches;
  3. ``--profile_frames`` frames under ``torch.profiler``: device time by
     kernel family, and the device's idle share over the adaptation loop
     (1 - kernel time / the run's own clock, profiler overhead included).
Prints one JSON object per run; with ``--out DIR`` also writes them to
``DIR/profile.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

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


def _config(path, frames=None):
    cfg = load_yaml(path)
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
        "launches": {k.__name__: k.launches for k in knn_ops.KERNELS},
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config_path", default=default_config_path())
    p.add_argument("--profile_frames", type=int, default=12)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_adaptation measures the card: no CUDA device found")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "build_s": cuda_build.build()}
    print(json.dumps(out), flush=True)

    _run(_config(args.config_path, 4))  # warm-up
    torch.cuda.reset_peak_memory_stats()
    timed = _run(_config(args.config_path))
    timed["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["timed"] = timed
    print(json.dumps({"timed": timed}), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled = _run(_config(args.config_path, args.profile_frames))
    # The run's own clock starts after the runner is built and the frames
    # are rendered, so the idle share is over the adaptation loop alone.
    wall_ms = profiled["elapsed_s"] * 1e3
    fam, kernels = {}, []
    busy_us = 0.0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if (not dev_us or evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False) or "#" in evt.key):
            continue  # annotations span kernels already counted
        busy_us += dev_us
        fam[_family(evt.key)] = fam.get(_family(evt.key), 0.0) + dev_us / 1e3
        kernels.append((dev_us / 1e3, evt.count, evt.key[:90]))
    kernels.sort(reverse=True)
    profiled.update({
        "wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3,
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
