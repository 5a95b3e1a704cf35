"""Output fine-tuning (OFT): optimise the depth maps, not the network.

    python -m e2eslam_tpu_torch.apps.train_depth_oft \\
        --config_path configs/config_train_depth_icl.yaml [--set SECTION.key=value ...]

The port of ``e2eslam_tpu/apps/train_depth_oft.py`` (the reference's
``train_depth_OFT.py``): per window, the ground-truth reconstruction as in
``apps/train_depth``, one frozen forward, then
``OPTIMIZATION.refinement_steps`` optimizer steps on the depth tensors
themselves (``train_depth_OFT.py:279-282``) with a fresh optimizer each
window: no backward pass through the network. ``RefinementEngine.oft_window``
runs a window; with ``DEBUG.print_metrics`` (and ``verbose``) the steps run
one ``oft_step`` at a time and print their metrics. Both give the same
depths.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from e2eslam_tpu_torch.apps.common import device_and_model, host_scalars, synchronize, window
from e2eslam_tpu_torch.apps.train_depth import gt_reconstruction
from e2eslam_tpu_torch.config import load_config
from e2eslam_tpu_torch.data.pipeline import make_dataset
from e2eslam_tpu_torch.engine.refine import RefinementEngine


def train(config, *, dataset=None, max_windows: Optional[int] = None, verbose: bool = True,
          device=None, model=None) -> Dict:
    """Run OFT over the windows. Returns ``{"engine", "metrics"`` (each
    window's last step, host floats), ``"depths"`` (the last window's
    optimized depths), ``"elapsed_s"`` (the window loop, the device's work
    waited for)}."""
    frames = list(config.DATA.frames)
    dataset = dataset if dataset is not None else make_dataset(
        config, sequence_length=len(frames))
    H, W = int(config.DATA.height), int(config.DATA.width)
    dev, model = device_and_model(config, device, model)
    capacity = len(frames) * H * W
    engine = RefinementEngine(config, model, map_capacity=capacity, device=dev)
    n = len(dataset) if max_windows is None else min(len(dataset), max_windows)
    all_metrics, depths = [], None
    per_step = bool(verbose and config.DEBUG.get("print_metrics"))
    synchronize(dev)
    t_start = time.perf_counter()
    for it in range(n):
        pair = window(dataset, it, dev)
        gt_map = gt_reconstruction(config, pair, capacity)
        if not per_step:
            depths, metrics = engine.oft_window(pair, gt_map)
        else:
            # One frozen forward; the depth maps are the variable. The
            # depth regularizer compares post-scaling depths.
            _, frozen = engine.predict_depth(pair.colors)
            initial = engine.apply_scaling(frozen, pair.gt_depths, pair.intrinsics).detach()
            oft = engine.oft_state(frozen)
            map_index = engine.build_map_index(gt_map)
            metrics = None
            for rs in range(int(config.OPTIMIZATION.refinement_steps)):
                metrics = engine.oft_step(oft, initial, pair, gt_map, map_index)
                m = host_scalars(metrics)
                print(f"iter {it} refine_step {rs} loss {m['total_loss']:.5f} "
                      f"abs_rel {m['abs_rel']:.5f}")
            depths = oft.depths.detach()
        all_metrics.append(host_scalars(metrics))
        if config.DEBUG.get("early_stop") and it >= int(config.DEBUG.get("iter_stop", 0)):
            break
    synchronize(dev)
    return {"engine": engine, "metrics": all_metrics, "depths": depths,
            "elapsed_s": time.perf_counter() - t_start}


def main(argv=None):
    config = load_config(argv)
    out = train(config)
    print(f"final abs_rel {out['metrics'][-1]['abs_rel']:.5f}")
    return out


if __name__ == "__main__":
    main()
