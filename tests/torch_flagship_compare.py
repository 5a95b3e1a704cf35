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
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch_omp  # noqa: E402,F401  (first: OpenMP's wait policy, before torch loads)
import conftest  # noqa: E402,F401  (JAX on the CPU, as the tests run it)

import argparse  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from e2eslam_tpu.engine.adaptation import OnlineAdaptation as JaxRunner  # noqa: E402
from e2eslam_tpu_torch.apps.profile_adaptation import flagship_config  # noqa: E402
from e2eslam_tpu_torch.config import default_config_path, load_yaml  # noqa: E402
from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation  # noqa: E402
from e2eslam_tpu_torch.models.convert import load_jax_params  # noqa: E402
from e2eslam_tpu_torch.models.depth_net import make_depth_model  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = p.parse_args(argv)

    def setup(cfg):
        cfg.DATA.height, cfg.DATA.width = args.height, args.height * 5 // 4
        cfg.DEMO.sequence_length = args.frames
        cfg.SETTINGS.compute_dtype = args.dtype
        return cfg

    jr = JaxRunner(setup(bench.flagship_cfg()))
    weights = jax.tree_util.tree_map(np.asarray, jax.device_get(
        (jr.state.params, jr.state.batch_stats)))
    want = jr.run(verbose=False)
    cfg = setup(flagship_config(load_yaml(default_config_path())))
    model = make_depth_model(cfg)
    load_jax_params(model, *weights)
    got = OnlineAdaptation(cfg, device="cpu", model=model).run(verbose=False)
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
