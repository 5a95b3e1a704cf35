"""Input corruption for the gradient-flow experiments.

The port of ``e2eslam_tpu/utils/corruption.py`` (the reference's
``utils/modify_images.py``): perturb the LAST frame of an RGB-D sequence --
uniform noise matched to the sequence's statistics on depth, white noise on
colour, a centred patch of ones, or a constant image -- then optimise the
corrupted images back through the differentiable SLAM graph
(``apps/gradient_experiments.py``).

Every function takes sequences ``[B, L, H, W, C]`` (C = 3 for colour, 1 for
depth), corrupts index ``-1`` along L and returns a new tensor. Noise comes
from a ``torch.Generator``: the JAX package's threefry draws have no torch
counterpart, so the noise matches them in range and shape only.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _uniform(generator: torch.Generator, like: Tensor, channels: int) -> Tensor:
    shape = (like.shape[0], like.shape[2], like.shape[3], channels)
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


def noise_depth(generator: torch.Generator, depths: Tensor, std, mean) -> Tensor:
    """The last depth frame replaced by uniform noise in [0, 1), scaled by
    ``std`` and shifted by ``mean`` (reference ``modify_images.py:3-44``)."""
    if depths.shape[-1] != 1:
        raise ValueError(f"expected depth with 1 channel, got {depths.shape[-1]}")
    out = depths.clone()
    out[:, -1] = _uniform(generator, depths, 1) * std + mean
    return out


def noise_color(generator: torch.Generator, colors: Tensor) -> Tensor:
    """The last colour frame replaced by white noise in [0, 1) (``:46-68``)."""
    if colors.shape[-1] != 3:
        raise ValueError(f"expected color with 3 channels, got {colors.shape[-1]}")
    out = colors.clone()
    out[:, -1] = _uniform(generator, colors, 3)
    return out


def remove_pixels(images: Tensor, mask_height: int, mask_width: int) -> Tensor:
    """A centred ``mask_height x mask_width`` patch of the last frame set to
    ones (``:71-152``)."""
    H, W = images.shape[2], images.shape[3]
    if not (0 <= mask_height < H and 0 <= mask_width < W):
        raise ValueError(f"mask {mask_height}x{mask_width} must be smaller than image {H}x{W}")
    y0 = H // 2 - mask_height // 2
    x0 = W // 2 - mask_width // 2
    out = images.clone()
    out[:, -1, y0:y0 + mask_height, x0:x0 + mask_width, :] = 1.0
    return out


def replace_image(images: Tensor, value: float = 1.0) -> Tensor:
    """The last frame replaced by a constant (``replace_depth/color``)."""
    out = images.clone()
    out[:, -1] = value
    return out


def corrupt_rgbd(config, generator: torch.Generator, colors: Tensor, depths: Tensor):
    """Corrupt per the ``DEPTH_RECOVER.*`` flags, in the reference's order
    (``corrupt_rgbd``, ``modify_images.py:154-233``). The depth noise's
    statistics are the whole sequence's mean and population standard
    deviation (``jnp.std``'s, ``correction=0``). Returns (noisy colours,
    noisy depths)."""
    dr = config.DEPTH_RECOVER
    noisy_colors, noisy_depths = colors, depths
    if dr.noise_depth:
        noisy_depths = noise_depth(generator, noisy_depths, depths.std(correction=0),
                                   depths.mean())
    if dr.noise_color:
        noisy_colors = noise_color(generator, noisy_colors)
    if dr.remove_pixels_depth:
        noisy_depths = remove_pixels(noisy_depths, dr.mask_height, dr.mask_width)
    if dr.remove_pixels_color:
        noisy_colors = remove_pixels(noisy_colors, dr.mask_height, dr.mask_width)
    if dr.replace_depth:
        noisy_depths = replace_image(noisy_depths)
    if dr.replace_color:
        noisy_colors = replace_image(noisy_colors)
    return noisy_colors, noisy_depths
