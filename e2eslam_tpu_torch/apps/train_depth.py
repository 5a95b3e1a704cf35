"""The development refinement harness: PFT over dataset windows against a
ground-truth reconstruction.

    python -m e2eslam_tpu_torch.apps.train_depth \\
        --config_path configs/config_train_depth_icl.yaml [--set SECTION.key=value ...]

The port of ``e2eslam_tpu/apps/train_depth.py`` (the reference's
``train_depth.py``, class ``Depth_Estimation``): for each window of
``len(DATA.frames)`` frames, the ground-truth point cloud is reconstructed
once by PointFusion with the dataset's poses (``capacity = F * H * W``),
indexed for the 3D losses (``RefinementEngine.build_map_index``: the
brute KNN's sorted view), and ``OPTIMIZATION.refinement_steps`` PFT steps
run with every enabled loss against it. The optimizer and its schedule
carry across windows; each window's step 0 takes the depth regularizer's
snapshot. ``DEBUG.early_stop`` stops after window ``DEBUG.iter_stop``.

Observability: with ``VIZ.log_gradients``, ``VIZ.grad_images`` or
``VIZ.tensorboard`` each window's last step runs through
``refine_step_with_grads``; its per-layer gradient norms go to the scalar
log (``SETTINGS.log_path``) and its histograms beside it, the designated
decoder layer's activation-gradient grid (``VIZ.grad_image_layer``, scaled
by ``VIZ.tensorboard_scaled``) to ``DEBUG.plot_path`` or the log's
``{name}_grads`` directory. The port computes these whenever the flags ask
and returns the last ones in its result; the JAX app computes the images
only when it has a directory to write them to. ``DEBUG.plot`` dumps the
window's frames at step 0 and the debug images every
``DEBUG.plot_interval`` steps. PNGs need matplotlib, imported when the
first one is written; ``render=False`` writes none and keeps everything
else. With ``SETTINGS.log_path`` the adapted network and its optimizer are
saved at the end into ``{log_path}/{name}_ckpt`` (``checkpoint.py``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch

from e2eslam_tpu_torch.apps.common import device_and_model, host_scalars, synchronize, window
from e2eslam_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from e2eslam_tpu_torch.config import load_config
from e2eslam_tpu_torch.data.pipeline import make_dataset
from e2eslam_tpu_torch.engine.refine import TARGET, RefinementEngine
from e2eslam_tpu_torch.slam.slam import PointFusion
from e2eslam_tpu_torch.viz.logging import ScalarLogger, gradient_histograms, write_histograms


def gt_reconstruction(config, pair, capacity: int):
    """The window's ground-truth map: PointFusion with the dataset's poses
    over every frame, outside autograd (reference train_depth.py:263-267)."""
    slam = PointFusion(odom="gt", sigma=float(config.MODEL.sigma),
                       fusion_impl=str(config.MODEL.get("fusion_impl", "scatter")))
    with torch.no_grad():
        gt_map, _ = slam(pair.colors, pair.gt_depths, pair.intrinsics, pair.poses,
                         capacity=capacity)
    return gt_map


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def train(config, *, dataset=None, max_windows: Optional[int] = None, verbose: bool = True,
          device=None, model=None, render: bool = True) -> Dict:
    """Run the harness. Returns ``{"engine", "metrics"`` (each window's last
    step, host floats), ``"first_metrics"`` (each window's first step),
    ``"global_step"``, ``"elapsed_s"`` (the window loop, the device's work
    waited for), and, when observed, ``"grad_norms"``,
    ``"grad_images"`` (NCHW) and ``"grads"`` of the last window's last
    step, on the host; ``"checkpoint"`` where one was saved}."""
    frames = list(config.DATA.frames)
    dataset = dataset if dataset is not None else make_dataset(
        config, sequence_length=len(frames))
    H, W = int(config.DATA.height), int(config.DATA.width)
    dev, model = device_and_model(config, device, model)
    capacity = len(frames) * H * W
    engine = RefinementEngine(config, model, map_capacity=capacity, device=dev)
    # A resumed run (reference train_depth.py:849-863): the network always,
    # the optimizer's state with OPTIMIZATION.load_optimizer.
    if config.MODEL.get("restore_checkpoint"):
        want_opt = bool(config.OPTIMIZATION.get("load_optimizer", False))
        load_checkpoint(config.MODEL.restore_checkpoint, engine.model,
                        engine.optimizer if want_opt else None)
    S, V, D = config.SETTINGS, config.VIZ, config.DEBUG
    logger = ScalarLogger(S.log_path, S.name) if S.get("log_path") else None
    observe = bool(V.get("tensorboard") or V.get("log_gradients") or V.get("grad_images"))
    want_images = bool(V.get("grad_images") or V.get("tensorboard"))
    grad_out_dir = D.get("plot_path") or (
        f"{S.log_path}/{S.name}_grads" if S.get("log_path") else None)
    plot_every = bool(render and D.get("plot") and D.get("plot_path"))
    plot_interval = int(D.get("plot_interval", 10) or 10)
    R = int(config.OPTIMIZATION.refinement_steps)

    n = len(dataset) if max_windows is None else min(len(dataset), max_windows)
    out: Dict = {"engine": engine, "metrics": [], "first_metrics": []}
    global_step = 0
    synchronize(dev)
    t_start = time.perf_counter()
    for it in range(n):
        pair = window(dataset, it, dev)
        gt_map = gt_reconstruction(config, pair, capacity)
        map_index = engine.build_map_index(gt_map)
        grads = metrics = None
        for rs in range(R):
            if observe and rs == R - 1:
                metrics, _, grads = engine.refine_step_with_grads(pair, gt_map, map_index,
                                                                  step=rs)
            else:
                metrics, _ = engine.refine_step(pair, gt_map, map_index, step=rs)
            global_step += 1
            if rs == 0:
                out["first_metrics"].append(metrics)
            need_host = (verbose and D.get("print_metrics")) or plot_every or logger
            if not need_host:
                continue
            m = host_scalars(metrics)
            if verbose and D.get("print_metrics"):
                print(f"iter {it} refine_step {rs} loss {m['total_loss']:.5f} "
                      f"abs_rel {m['abs_rel']:.5f} a1 {m['a1']:.5f}")
            if plot_every:
                _plot_step(config, pair, metrics, it, rs, plot_interval)
            if logger is not None:
                logger.log(global_step, m)
                if "grad_norms" in metrics:
                    logger.log(global_step, host_scalars(metrics["grad_norms"]),
                               prefix="grad_norm/")
        if metrics is None:
            continue
        out["metrics"].append(host_scalars(metrics))
        if "debug_images" in metrics and D.get("plot_path") and render:
            from e2eslam_tpu_torch.viz.images import dump_debug_images

            dump_debug_images(_to_host(metrics["debug_images"]), D.plot_path, f"iter{it:04d}")
        if grads is not None:
            out["grads"] = _to_host(grads)
            out["grad_norms"] = host_scalars(metrics.get("grad_norms", {}))
            if logger is not None:
                write_histograms(gradient_histograms(grads), logger, step=global_step)
        if "grad_images" in metrics:
            grad_images = _to_host(metrics["grad_images"])
            out["grad_images"] = grad_images
            if want_images and grad_out_dir is not None and render:
                from e2eslam_tpu_torch.viz.images import dump_gradient_images

                dump_gradient_images(
                    grad_images, grad_out_dir, f"iter{it:04d}",
                    layer=str(V.get("grad_image_layer") or "upconv_0_1"),
                    scaled=bool(V.get("tensorboard_scaled")),
                    writer=getattr(logger, "_tb", None))
            if logger is not None:
                write_histograms(gradient_histograms(grad_images), logger, step=global_step,
                                 prefix="grad_act/")
        if D.get("early_stop") and it >= int(D.get("iter_stop", 0)):
            break

    synchronize(dev)
    out["elapsed_s"] = time.perf_counter() - t_start
    if logger is not None:
        logger.close()
    out["first_metrics"] = [host_scalars(m) for m in out["first_metrics"]]
    out["global_step"] = global_step
    # The adapted network and its optimizer (the reference never saved
    # them, train_depth.py:847).
    if S.get("log_path"):
        ckpt = os.path.join(S.log_path, f"{S.name}_ckpt")
        save_checkpoint(ckpt, engine.model, engine.optimizer,
                        meta={"global_step": global_step})
        out["checkpoint"] = ckpt
        if verbose:
            print("checkpoint saved to", ckpt)
    return out


def _plot_step(config, pair, metrics, it: int, rs: int, plot_interval: int) -> None:
    """Per-step dumps at the reference's cadence (train_depth.py:551-612):
    the target and source frames at step 0, the debug images every
    ``plot_interval`` steps."""
    from e2eslam_tpu_torch.viz.images import dump_debug_images, save_rgb

    plot_path = config.DEBUG.plot_path
    if rs == 0:
        frames = pair.colors.detach().cpu().numpy()
        save_rgb(f"{plot_path}/iter{it:04d}_step{rs}_tF.png", frames[TARGET])
        srcs = [s for s in range(frames.shape[0]) if s != TARGET]
        for sn, s in enumerate(srcs, start=1):
            save_rgb(f"{plot_path}/iter{it:04d}_step{rs}_sF{sn}.png", frames[s])
    if rs % plot_interval == 0 and "debug_images" in metrics:
        dump_debug_images(_to_host(metrics["debug_images"]), plot_path,
                          f"iter{it:04d}_step{rs}")


def main(argv=None):
    config = load_config(argv)
    out = train(config)
    final = out["metrics"][-1]
    print(f"final abs_rel {final['abs_rel']:.5f} a1 {final['a1']:.5f}")
    return out


if __name__ == "__main__":
    main()
