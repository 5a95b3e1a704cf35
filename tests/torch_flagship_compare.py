"""The port's flagship run against the JAX runner's, both on the CPU, at a
size the tests do not reach: a quality comparison (keyframes, abs_rel,
losses, map size), no timing.

    python tests/torch_flagship_compare.py --height 128 --frames 20 \\
        [--dtype bfloat16|float32]

The flagship settings (bench.py::flagship_cfg on the JAX side, the port's
copy ``profile_adaptation.flagship_config``) at ``--height`` x 5/4 of it,
``--frames`` frames, the JAX runner with its whole-sequence program, the
port from the same flax weights. Prints one JSON line per keyframe and a
summary line.

    python tests/torch_flagship_compare.py --height 256 --frames 60 \\
        --seeds 0 1 2 [--sides jax port] [--limit-min 20] [--out FILE]

runs each side of ``--sides`` alone, once per weight seed (the flax
initialisation from ``jax.random.key(seed)``; the port loads the same
weights), each run in a process of its own stopped after ``--limit-min``
minutes, and prints one summary line per run (side, seed, mean abs_rel,
keyframes, map size, seconds; or the time a stopped run had): the spread
of mean abs_rel over seeds on each side, at the flagship's full size with
the defaults above. Both sides run their per-keyframe loops and print each
refinement step (the JAX runner with ``use_sequence_program`` off), so a
stopped run still reports the keyframes it reached; per seed, a last line
holds both sides' mean abs_rel over the keyframes both reached.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch_omp  # noqa: E402,F401  (first: OpenMP's wait policy, before torch loads)
import conftest  # noqa: E402,F401  (JAX on the CPU, as the tests run it)

import argparse  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from e2eslam_tpu.engine.adaptation import OnlineAdaptation as JaxRunner  # noqa: E402
from e2eslam_tpu.models.depth_net import init_depth_model  # noqa: E402
from e2eslam_tpu_torch.apps.profile_adaptation import flagship_config  # noqa: E402
from e2eslam_tpu_torch.config import default_config_path, load_yaml  # noqa: E402
from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation  # noqa: E402
from e2eslam_tpu_torch.models.convert import load_jax_params  # noqa: E402
from e2eslam_tpu_torch.models.depth_net import make_depth_model  # noqa: E402


def _runner(args, seed):
    """The JAX runner at the requested size, its network initialised from
    ``jax.random.key(seed)``; returns (runner, host weights)."""
    cfg = bench.flagship_cfg()
    cfg.DATA.height, cfg.DATA.width = args.height, args.height * 5 // 4
    cfg.DEMO.sequence_length = args.frames
    cfg.SETTINGS.compute_dtype = args.dtype
    jr = JaxRunner(cfg)
    if seed:
        params, stats = init_depth_model(jr.model, jax.random.key(seed), args.height,
                                         args.height * 5 // 4)
        jr.state = jr.engine.init_state(params, stats, (jr.F_ref, args.height,
                                                        args.height * 5 // 4))
    weights = jax.tree_util.tree_map(np.asarray, jax.device_get(
        (jr.state.params, jr.state.batch_stats)))
    return jr, weights


def _port_run(args, weights, verbose=False):
    cfg = flagship_config(load_yaml(default_config_path()))
    cfg.DATA.height, cfg.DATA.width = args.height, args.height * 5 // 4
    cfg.DEMO.sequence_length = args.frames
    cfg.SETTINGS.compute_dtype = args.dtype
    model = make_depth_model(cfg)
    load_jax_params(model, *weights)
    runner = OnlineAdaptation(cfg, device="cpu", model=model)
    runner.use_sequence_program = False  # as the JAX side: the per-keyframe loop
    return runner.run(verbose=verbose)


def _one(args):
    """One side, one seed: its summary line."""
    t0 = time.perf_counter()
    jr, weights = _runner(args, args.seed)
    # The per-keyframe loop, which reports each keyframe as it ends (the
    # whole-sequence program reports nothing before the end).
    jr.use_sequence_program = False
    r = jr.run(verbose=True) if args.side == "jax" else _port_run(args, weights, verbose=True)
    print(json.dumps({"side": args.side, "seed": args.seed, "height": args.height,
                      "frames": args.frames, "dtype": args.dtype,
                      "mean_abs_rel": float(r["mean_abs_rel"]),
                      "keyframes": int(r["num_keyframes"]),
                      "map_points": int(r["map_points"]),
                      "seconds": time.perf_counter() - t0}), flush=True)


STEP_LINE = re.compile(r"^frame (\d+) refine_step (\d+) .*abs_rel ([-+0-9.eE]+|nan)")


def _per_keyframe(stdout: str) -> dict:
    """{frame: abs_rel of its last refinement step} from a run's step lines."""
    out = {}
    for ln in (stdout or "").splitlines():
        m = STEP_LINE.match(ln)
        if m:
            out[int(m.group(1))] = float(m.group(3))
    return out


def _seeds(args, argv):
    """Each side alone per seed, each run in its own process under the time
    limit; a stopped run's line says how far it got. Per seed, a last line
    compares the sides over the keyframes both reached."""
    lines = []

    def emit(line):
        print(json.dumps(line), flush=True)
        lines.append(line)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")

    for seed in args.seeds:
        reached = {}
        for side in args.sides:
            cmd = [sys.executable, "-u", os.path.abspath(__file__), "--height",
                   str(args.height), "--frames", str(args.frames), "--dtype", args.dtype,
                   "--side", side, "--seed", str(seed)]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=args.limit_min * 60)
                stdout = proc.stdout
                rows = [ln for ln in stdout.splitlines() if ln.startswith("{")]
                line = json.loads(rows[-1]) if rows else {
                    "side": side, "seed": seed, "failed": proc.stderr[-500:]}
            except subprocess.TimeoutExpired as e:
                stdout = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
                line = {"side": side, "seed": seed, "stopped_after_s": time.perf_counter() - t0,
                        "reason": f"no result within {args.limit_min} min"}
            per_kf = _per_keyframe(stdout)
            reached[side] = per_kf
            line["keyframes_reached"] = len(per_kf)
            line["per_keyframe_abs_rel"] = {str(k): v for k, v in sorted(per_kf.items())}
            emit(line)
        if len(reached) == 2:
            common = sorted(set(reached["jax"]) & set(reached["port"]))
            emit({"seed": seed, "common_keyframes": len(common),
                  **{f"mean_abs_rel_{side}": (float(np.mean([reached[side][k] for k in common]))
                                              if common else float("nan"))
                     for side in ("jax", "port")}})
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    p.add_argument("--seeds", type=int, nargs="*", default=None)
    p.add_argument("--sides", nargs="+", choices=("jax", "port"), default=["jax", "port"])
    p.add_argument("--side", choices=("jax", "port"), default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit-min", type=float, default=20.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.side:
        return _one(args)
    if args.seeds is not None:
        return _seeds(args, argv)

    jr, weights = _runner(args, 0)
    want = jr.run(verbose=False)
    got = _port_run(args, weights)
    for k, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
        print(json.dumps({"keyframe": k, **{f"{key}_{side}": float(m[key])
                                             for key in ("abs_rel", "total_loss", "three3d")
                                             for side, m in (("port", a), ("jax", b))}}))
    print(json.dumps({"height": args.height, "frames": args.frames, "dtype": args.dtype,
                      "same_keyframes": got["keyframes"] == [int(k) for k in want["keyframes"]],
                      "mean_abs_rel_port": got["mean_abs_rel"],
                      "mean_abs_rel_jax": float(want["mean_abs_rel"]),
                      "map_points_port": got["map_points"],
                      "map_points_jax": int(want["map_points"])}))


if __name__ == "__main__":
    main()
