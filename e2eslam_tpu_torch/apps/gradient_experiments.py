"""Gradient-flow experiments: recover corrupted images through the SLAM graph.

    python -m e2eslam_tpu_torch.apps.gradient_experiments --config_path configs/config.yaml

The port of ``e2eslam_tpu/apps/gradient_experiments.py`` (the reference's
``gradient_experiments.py``, class ``Gradient_Flow``, with
``slam/custom_slam.py``): corrupt the last frame of the first window
(``DEPTH_RECOVER.*``, ``utils/corruption.py``), reconstruct the map of the
corrupted sequence by PointFusion under autograd, and optimise the corrupted
colours and depths themselves (``DEPTH_RECOVER.optimize_color`` /
``optimize_depth``) with the KNN and colour point losses against the clean
reconstruction: the whole pipeline is differentiable. The update is optax's
``adam`` (no schedule) through the port's optimizer factory; the loss's
nearest neighbours come from the exact KNN kernels (cold calls between two
map buffers of ``F * H * W`` rows: past the resident kernel's limit at
320x256, the dense kernel).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from e2eslam_tpu_torch.apps.common import window
from e2eslam_tpu_torch.config import Config, load_config
from e2eslam_tpu_torch.data.pipeline import make_dataset
from e2eslam_tpu_torch.device import resolve_device, set_full_fp32
from e2eslam_tpu_torch.engine.optim import make_optimizer
from e2eslam_tpu_torch.losses.points import color_points_loss, knn_points_loss
from e2eslam_tpu_torch.slam.slam import PointFusion
from e2eslam_tpu_torch.utils.corruption import corrupt_rgbd


def make_loss_fn(config, pair, noisy_colors, noisy_depths):
    """The experiment's loss (``gradient_experiments.py:54-66`` of the JAX
    package): ``loss_fn(variables)`` reconstructs the map of the window with
    ``variables["colors"]`` / ``["depths"]`` (default the corrupted ones)
    and returns (KNN loss + colour loss, {"knn", "color"}), against the
    clean window's map (built here once, outside autograd)."""
    slam = PointFusion(odom="gt", sigma=float(config.MODEL.sigma),
                       fusion_impl=str(config.MODEL.get("fusion_impl", "scatter")))
    F, H, W = pair.colors.shape[:3]
    capacity = F * H * W
    with torch.no_grad():
        gt_map, _ = slam(pair.colors, pair.gt_depths, pair.intrinsics, pair.poses,
                         capacity=capacity)

    def loss_fn(variables):
        c = variables.get("colors", noisy_colors)
        d = variables.get("depths", noisy_depths)
        noisy_map, _ = slam(c, d, pair.intrinsics, pair.poses, capacity=capacity)
        knn_l, idx = knn_points_loss(gt_map.points, noisy_map.points, n_gt=gt_map.count,
                                     n_query=noisy_map.count)
        color_l = color_points_loss(gt_map.colors, noisy_map.colors, idx,
                                    n_query=noisy_map.count)
        return knn_l + color_l, {"knn": knn_l.detach(), "color": color_l.detach()}

    return loss_fn


def recover_image(config, *, dataset=None, num_steps: Optional[int] = None,
                  verbose: bool = True, device=None, noisy=None) -> Dict:
    """Run the experiment. ``noisy``: (colours, depths) ``[F, H, W, C]`` to
    start from instead of corrupting the window with a generator seeded
    with 0. Returns ``{"history"`` (the loss before each step),
    ``"recovered"``, ``"initial_loss"``, ``"final_loss"}``."""
    dev = resolve_device(device, config)
    set_full_fp32()
    seqlen = len(config.DATA.frames)
    dataset = dataset if dataset is not None else make_dataset(
        config, sequence_length=max(seqlen, 2))
    pair = window(dataset, 0, dev)
    if noisy is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        noisy_colors, noisy_depths = corrupt_rgbd(config, gen, pair.colors[None],
                                                  pair.gt_depths[None])
        noisy = (noisy_colors[0], noisy_depths[0])
    noisy_colors, noisy_depths = (t.to(dev) for t in noisy)
    loss_fn = make_loss_fn(config, pair, noisy_colors, noisy_depths)

    variables = {}
    if config.DEPTH_RECOVER.optimize_color:
        variables["colors"] = noisy_colors.clone().requires_grad_(True)
    if config.DEPTH_RECOVER.optimize_depth:
        variables["depths"] = noisy_depths.clone().requires_grad_(True)
    # optax.adam(learning_rate): Adam without a schedule.
    opt_cfg = Config(config.to_dict())
    opt_cfg.OPTIMIZATION.optimizer = "Adam"
    opt_cfg.OPTIMIZATION.schedular = None
    opt_cfg.OPTIMIZATION.fused_update = False
    optimizer, _ = make_optimizer(opt_cfg, list(variables.values()))

    steps = num_steps or int(config.OPTIMIZATION.refinement_steps)
    history = []
    for s in range(steps):
        optimizer.zero_grad(set_to_none=True)
        loss, _ = loss_fn(variables)
        loss.backward()
        optimizer.step()
        history.append(float(loss.detach()))
        if verbose:
            print(f"step {s} loss {history[-1]:.6f}")
    return {"history": history, "recovered": {k: v.detach() for k, v in variables.items()},
            "initial_loss": history[0], "final_loss": history[-1]}


def main(argv=None):
    config = load_config(argv)
    out = recover_image(config)
    print(f"loss {out['initial_loss']:.6f} -> {out['final_loss']:.6f} "
          f"({'improved' if out['final_loss'] < out['initial_loss'] else 'NOT improved'})")
    return out


if __name__ == "__main__":
    main()
