"""Debug image dumps (reference ``DEBUG.plot``, ``train_depth.py:551-612``).

The port of ``e2eslam_tpu/viz/images.py``: matplotlib (Agg backend, imported
when a dump is written, never at import) renders synthesized frames,
photometric error maps, depth maps and the decoder's activation-gradient
grids to PNG files in ``DEBUG.plot_path``. Images arrive as tensors or
arrays; the activation gradients in the port's NCHW layout.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _savefig(array, path, *, cmap: Optional[str] = None, title=None):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4.5), dpi=110)
    im = ax.imshow(_host(array), cmap=cmap)
    ax.set_axis_off()
    if title:
        ax.set_title(title, fontsize=9)
    if cmap is not None:
        fig.colorbar(im, ax=ax, fraction=0.04)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def save_rgb(path: str, image) -> str:
    """RGB image in [0, 1], shape [H, W, 3]."""
    return _savefig(np.clip(_host(image), 0.0, 1.0), path)


def save_depth(path: str, depth, *, cmap: str = "magma") -> str:
    """Depth or disparity map, shape [H, W]."""
    return _savefig(depth, path, cmap=cmap, title="depth")


def save_error(path: str, error, *, cmap: str = "inferno") -> str:
    """Per-pixel photometric error map, shape [H, W]."""
    return _savefig(error, path, cmap=cmap, title="photometric error")


def tensorboard_scaled(g: np.ndarray) -> np.ndarray:
    """The reference's ``VIZ.tensorboard_scaled`` normalisation: divide by
    (min + max), by 1 where that sum is exactly 0 (train_depth.py:871-878)."""
    s = float(g.min() + g.max())
    return g / (s if s != 0.0 else 1.0)


def _first_hwc(grad) -> np.ndarray:
    """The first batch element of an NCHW gradient as [H, W, C] float32."""
    g = _host(grad).astype(np.float32)
    if g.ndim == 4:
        g = g[0]
    return np.transpose(g, (1, 2, 0))


def save_gradient_image_grid(path: str, grad, *, scaled: bool = False,
                             cmap: str = "coolwarm", max_channels: int = 64,
                             title: Optional[str] = None) -> str:
    """A per-channel grid of one decoder tap's activation gradient
    ``[B, C, H, W]`` (its first batch element), one tile per channel: the
    reference's ``writer.add_images("Image_Layer_{idx}...")`` at its
    designated decoder layer (``train_depth.py:880-917``). ``scaled``
    applies ``tensorboard_scaled``."""
    plt = _pyplot()
    g = _first_hwc(grad)
    if scaled:
        g = tensorboard_scaled(g)
    C = min(g.shape[-1], max_channels)
    cols = int(np.ceil(np.sqrt(C)))
    rows = int(np.ceil(C / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(2.2 * cols, 1.8 * rows), dpi=100)
    axes = np.atleast_1d(axes).reshape(-1)
    vmax = float(np.abs(g[..., :C]).max()) or 1.0
    for c in range(C):
        axes[c].imshow(g[..., c], cmap=cmap, vmin=-vmax, vmax=vmax)
    for ax in axes:
        ax.set_axis_off()
    if title:
        fig.suptitle(title, fontsize=10)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def dump_gradient_images(grad_images: Dict, out_dir: str, tag: str, *,
                         layer: str = "upconv_0_1", scaled: bool = False,
                         writer=None) -> Dict[str, str]:
    """Write the grid of the tap ``layer`` (default the last 16-channel
    decoder conv before the disparity head) from the engine's
    ``grad_images``, and with a tensorboardX ``writer`` its channels as
    images, normalised the same way."""
    if layer not in grad_images:
        raise KeyError(f"grad layer {layer!r} not in taps {sorted(grad_images)}")
    paths = {layer: save_gradient_image_grid(
        os.path.join(out_dir, f"{tag}_grad_{layer}.png"), grad_images[layer], scaled=scaled,
        title=f"dLoss/d({layer}) {tag}")}
    if writer is not None:
        img = _first_hwc(grad_images[layer])
        if scaled:
            img = tensorboard_scaled(img)
        writer.add_images(f"Image_Layer_{layer}_{tag}",
                          np.transpose(img, (2, 0, 1))[:, None, :, :], dataformats="NCHW")
    return paths


def dump_debug_images(images: Dict, out_dir: str, tag: str) -> Dict[str, str]:
    """Write the engine's ``debug_images`` (``synthesized_frame`` [H, W, 3],
    ``photometric_error``, ``depth`` and ``texture_gate`` [H, W]) to PNGs."""
    paths = {}
    if "synthesized_frame" in images:
        paths["synthesized_frame"] = save_rgb(os.path.join(out_dir, f"{tag}_synth.png"),
                                              images["synthesized_frame"])
    if "photometric_error" in images:
        paths["photometric_error"] = save_error(os.path.join(out_dir, f"{tag}_photo_err.png"),
                                                images["photometric_error"])
    if "depth" in images:
        paths["depth"] = save_depth(os.path.join(out_dir, f"{tag}_depth.png"), images["depth"])
    if "texture_gate" in images:
        # Where the 3D loss may supervise (1 = photometric-blind).
        paths["texture_gate"] = save_error(os.path.join(out_dir, f"{tag}_texgate.png"),
                                           images["texture_gate"])
    return paths
