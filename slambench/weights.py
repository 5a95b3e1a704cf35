"""Seeded weights of a configuration's depth network, made on the device.

Flax's default initialisers, as the port's ``make_depth_model`` uses them,
drawn in one call from a ``torch.Generator`` on the card: every
convolution kernel from a normal truncated at two standard deviations
(inverse CDF of one uniform draw), scaled to variance ``1 / fan_in`` after
the truncation (lecun normal); biases 0; batch norm scale 1, bias 0, mean 0,
variance 1. The tensors to draw, named as the network's state dict, are
the configuration's reference module's ``network_shapes()``
(``reference/__init__.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def seeded_weights(seed: int, device, shapes: Sequence[tuple]) -> Dict[str, torch.Tensor]:
    """The tensors ``shapes`` (``(name, shape, kind)``) drawn from ``seed``:
    every ``conv`` kernel from one uniform draw in the order listed, the
    other kinds filled."""
    convs = [(name, shape) for name, shape, kind in shapes if kind == "conv"]
    sizes = [math.prod(s) for _, s in convs]
    stds = torch.tensor([math.sqrt(1.0 / (s[1] * s[2] * s[3])) / TRUNC_STD for _, s in convs],
                        device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    lo, hi = 0.5 * math.erfc(2.0 / math.sqrt(2.0)), 0.5 * math.erfc(-2.0 / math.sqrt(2.0))
    u = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float64)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    flat = (x * torch.repeat_interleave(stds.double(), torch.tensor(sizes, device=device))).float()
    out = {name: t.reshape(shape) for (name, shape), t in zip(convs, flat.split(sizes))}
    fill = {"bias": 0.0, "bn_weight": 1.0, "bn_bias": 0.0, "bn_mean": 0.0, "bn_var": 1.0}
    for name, shape, kind in shapes:
        if kind in fill:
            out[name] = torch.full(shape, fill[kind], device=device)
        elif kind == "bn_count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
    return out
