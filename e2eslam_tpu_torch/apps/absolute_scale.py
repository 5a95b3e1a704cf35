"""The learned affine depth scale: a grid search of scale-only training.

    python -m e2eslam_tpu_torch.apps.absolute_scale \\
        --config_path configs/config_scale_learning.yaml [--set SECTION.key=value ...]

The port of ``e2eslam_tpu/apps/absolute_scale.py`` (the reference's
``absolute_scale.py``): for each initial value in ``SCALE_GRID_SEARCH.grid``
(reference ``:268``), train only a global scale (and, with
``ABLATION.with_bias``, a bias) on the frozen network's depth with the
view-synthesis loss (``absolute_scale.py:207-240``), over every window,
``OPTIMIZATION.refinement_steps`` steps each; report the learned values and
the best entry by final loss (the reference's published ICL result: scale
6.0891, bias -1.0958). On a copy of the config the other scaling
(``ABLATION.scaled_depth``) and the 3D losses are off: the map stays empty,
so they would be zero anyway, and no KNN runs. The windows are loaded once,
and each window's frozen forward runs once for the whole grid.
"""

from __future__ import annotations

from typing import Dict, Optional

from e2eslam_tpu_torch.apps.common import device_and_model, host_scalars, window
from e2eslam_tpu_torch.config import Config, load_config
from e2eslam_tpu_torch.data.pipeline import make_dataset
from e2eslam_tpu_torch.engine.refine import RefinementEngine


def train_scale(config, *, dataset=None, max_windows: Optional[int] = None,
                verbose: bool = True, device=None, model=None) -> Dict:
    """Returns ``{"results": [{"init", "scale", "bias", "final_loss",
    "abs_rel"}, ...], "best": the entry of least final loss}``."""
    frames = list(config.DATA.frames)
    dataset = dataset if dataset is not None else make_dataset(
        config, sequence_length=len(frames))
    H, W = int(config.DATA.height), int(config.DATA.width)
    dev, model = device_and_model(config, device, model)
    cfg = Config(config.to_dict())
    cfg.ABLATION.scaled_depth = False
    cfg.LOSS.three3d_loss = False
    cfg.LOSS.knn_points = False
    cfg.LOSS.chamfer_distance = False
    engine = RefinementEngine(cfg, model, map_capacity=len(frames) * H * W, device=dev)
    empty = engine.make_empty_map()
    use_bias = bool(config.ABLATION.get("with_bias", False))
    grid = list(config.get("SCALE_GRID_SEARCH", {}).get("grid", [0.5]))
    n = len(dataset) if max_windows is None else min(len(dataset), max_windows)
    pairs = [window(dataset, it, dev) for it in range(n)]
    frozen = [engine.predict_depth(p.colors) for p in pairs]

    results = []
    for init_value in grid:
        sc = engine.scale_state(float(init_value), use_bias)
        metrics = None
        for pair, fz in zip(pairs, frozen):
            for _ in range(int(config.OPTIMIZATION.refinement_steps)):
                metrics = engine.scale_step(sc, pair, empty, fz)
        m = host_scalars(metrics)
        entry = {"init": float(init_value), "scale": float(sc.params["scale"].detach()),
                 "bias": float(sc.params["bias"].detach()) if use_bias else 0.0,
                 "final_loss": m["total_loss"], "abs_rel": m["abs_rel"]}
        results.append(entry)
        if verbose:
            print(f"init {entry['init']:.3f} -> scale {entry['scale']:.4f} "
                  f"bias {entry['bias']:.4f} loss {entry['final_loss']:.5f}")
    best = min(results, key=lambda e: e["final_loss"])
    return {"results": results, "best": best}


def main(argv=None):
    config = load_config(argv)
    out = train_scale(config)
    b = out["best"]
    print(f"best: scale {b['scale']:.4f} bias {b['bias']:.4f} (init {b['init']})")
    return out


if __name__ == "__main__":
    main()
