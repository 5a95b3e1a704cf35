"""Online refinement under a constant affine depth scale.

    python -m e2eslam_tpu_torch.apps.test_depth_scaling \\
        --config_path CONFIG [--set ABLATION.scaling_depth=6.09 ...]

The port of ``e2eslam_tpu/apps/test_depth_scaling.py`` (the reference's
``test_depth_scaling.py``): PFT over the dataset's windows with the
constant scaling ``depth * ABLATION.scaling_depth (+ ABLATION.scaling_bias
with ABLATION.with_bias)`` (reference ``:269-273, :301-305``), against an
empty map (the 3D losses are off on a copy of the config: they would be
zero), printing metrics; with ``DEBUG.plot`` the scaled target depth is
saved as ``.npy`` every ``DUMP_EVERY`` steps (reference ``:374-380``) into
``DEBUG.plot_path``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from e2eslam_tpu_torch.apps.common import device_and_model, host_scalars, window
from e2eslam_tpu_torch.config import Config, load_config
from e2eslam_tpu_torch.data.pipeline import make_dataset
from e2eslam_tpu_torch.engine.refine import TARGET, RefinementEngine

DUMP_EVERY = 6


def evaluate(config, *, dataset=None, max_windows: Optional[int] = None,
             verbose: bool = True, device=None, model=None) -> Dict:
    """Returns ``{"metrics"`` (each window's last step, host floats),
    ``"mean_abs_rel"``, ``"dumps"`` (the paths written)}."""
    cfg = Config(config.to_dict())
    cfg.ABLATION.scaled_depth = True
    cfg.ABLATION.scaled_depth_mode = "constant"
    cfg.LOSS.three3d_loss = False
    cfg.LOSS.knn_points = False
    cfg.LOSS.chamfer_distance = False
    frames = list(cfg.DATA.frames)
    dataset = dataset if dataset is not None else make_dataset(
        cfg, sequence_length=len(frames))
    H, W = int(cfg.DATA.height), int(cfg.DATA.width)
    dev, model = device_and_model(cfg, device, model)
    engine = RefinementEngine(cfg, model, map_capacity=len(frames) * H * W, device=dev)
    empty = engine.make_empty_map()
    plot_dir = cfg.DEBUG.get("plot_path") or "."
    n = len(dataset) if max_windows is None else min(len(dataset), max_windows)
    all_metrics, dumps = [], []
    for it in range(n):
        pair = window(dataset, it, dev)
        metrics = None
        for rs in range(int(cfg.OPTIMIZATION.refinement_steps)):
            metrics, _ = engine.refine_step(pair, empty, step=rs)
            if verbose and cfg.DEBUG.get("print_metrics"):
                m = host_scalars(metrics)
                print(f"iter {it} refine_step {rs} abs_rel {m['abs_rel']:.5f} "
                      f"rmse {m['rmse']:.5f}")
            if cfg.DEBUG.get("plot") and rs % DUMP_EVERY == 0:
                # The SCALED depth the metrics see, through the engine's
                # own scaling, after this step's update.
                _, depth = engine.predict_depth(pair.colors)
                depth = engine.apply_scaling(depth, pair.gt_depths, pair.intrinsics)
                os.makedirs(plot_dir, exist_ok=True)
                path = os.path.join(plot_dir, f"depth_it{it}_rs{rs}.npy")
                np.save(path, depth[TARGET, ..., 0].cpu().numpy())
                dumps.append(path)
        all_metrics.append(host_scalars(metrics))
        if cfg.DEBUG.get("early_stop") and it >= int(cfg.DEBUG.get("iter_stop", 0)):
            break
    mean_abs_rel = float(np.mean([m["abs_rel"] for m in all_metrics]))
    return {"metrics": all_metrics, "mean_abs_rel": mean_abs_rel, "dumps": dumps}


def main(argv=None):
    config = load_config(argv)
    out = evaluate(config)
    print(f"mean abs_rel with scaling: {out['mean_abs_rel']:.5f}")
    return out


if __name__ == "__main__":
    main()
