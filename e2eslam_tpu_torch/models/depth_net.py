"""The depth networks (``MODEL.depth_network``).

``DispResNetIndoor`` (``indoor``, reference ``networks.py:224-238``): ResNet
encoder + indoor decoder. ``MonodepthNet`` (``monodepth2``, the reference's
encoder and depth decoder pair, ``online_adaption.py:129-141``): ResNet
encoder + monodepth2 decoder. Images enter NHWC ``[B, H, W, 3]`` in [0, 1]
and the scale-0 disparity leaves NHWC ``[B, H, W, 1]`` (the decoders return
every scale they emit); the convolutions run NCHW inside. ``dtype``
(``SETTINGS.compute_dtype``) is the activations' dtype, the disparity's
too: the engine casts it to float32 (``e2eslam_tpu/engine/refine.py:237``).
Batch norm always runs in inference mode (the refinement freezes it, and
the JAX forward passes ``train=False``): the model is put in ``eval()`` at
construction and ``train()`` keeps it there. ``taps`` reach the decoder
(``models/decoders.py``).

``AffineScale`` and ``ScaleLayer`` are the reference's learned global depth
scales (``networks.py:191-215``; ``e2eslam_tpu/models/depth_net.py:65-100``).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
from torch import nn

from e2eslam_tpu_torch.models.decoders import DepthDecoder, IndoorDepthDecoder
from e2eslam_tpu_torch.models.resnet import ResnetEncoder

Tensor = torch.Tensor


class _EncoderDecoder(nn.Module):
    """A ResNet encoder and a U-Net decoder; NHWC in, the scale-0 NHWC
    disparity out (only that head runs)."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.eval()

    def train(self, mode: bool = True):
        # Batch norm stays in inference mode (frozen statistics).
        return super().train(False)

    def forward(self, x: Tensor, taps=None) -> Tensor:
        return self.decode(self.encode(x), taps=taps)

    def encode(self, x: Tensor) -> List[Tensor]:
        """NHWC images -> the encoder's five NCHW feature maps."""
        return self.encoder(x.permute(0, 3, 1, 2))

    def decode(self, features: Sequence[Tensor], taps=None) -> Tensor:
        """The encoder's features -> the scale-0 NHWC disparity."""
        return self.decoder(features, scales=(0,), taps=taps)[0].permute(0, 2, 3, 1)


class DispResNetIndoor(_EncoderDecoder):
    """ResNet encoder + indoor decoder (``10 * sigmoid + 0.01``)."""

    def __init__(self, num_layers: int = 18, dtype: torch.dtype = torch.float32):
        encoder = ResnetEncoder(num_layers, dtype=dtype)
        super().__init__(encoder, IndoorDepthDecoder(encoder.num_ch_enc))


class MonodepthNet(_EncoderDecoder):
    """ResNet encoder + monodepth2 decoder (sigmoid disparity)."""

    def __init__(self, num_layers: int = 18, scales: Sequence[int] = (0, 1, 2, 3),
                 dtype: torch.dtype = torch.float32):
        encoder = ResnetEncoder(num_layers, dtype=dtype)
        super().__init__(encoder, DepthDecoder(encoder.num_ch_enc, scales))


class AffineScale(nn.Module):
    """A learned global scale (+ optional offset) of a depth map: the
    reference's ``Conv1x1`` initialised to ``init_value``. Published learned
    values for ICL: scale 6.0891, bias -1.0958 (reference README.md:183-184)."""

    def __init__(self, init_value: float = 0.5, use_bias: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))
        self.bias = nn.Parameter(torch.tensor(0.0)) if use_bias else None

    def forward(self, x: Tensor) -> Tensor:
        out = x * self.scale
        return out if self.bias is None else out + self.bias


class ScaleLayer(nn.Module):
    """A single learned scalar multiplier, initialised to ``init_value``."""

    def __init__(self, init_value: float = 0.5):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x: Tensor) -> Tensor:
        return x * self.scale


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's default initialisers, drawn from ``generator``.

    Conv kernels: ``lecun_normal`` (truncated normal at two standard
    deviations, variance 1/fan_in after the truncation correction); conv
    biases zero; batch-norm scale 1, bias 0, running mean 0, variance 1.
    """
    # Standard deviation of a unit normal truncated to [-2, 2].
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                std = math.sqrt(1.0 / fan_in) / trunc_std
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


def compute_dtype(config) -> torch.dtype:
    """The CNN's activation dtype, ``SETTINGS.compute_dtype``."""
    name = str(config.SETTINGS.get("compute_dtype", "float32"))
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"SETTINGS.compute_dtype {name!r}: float32 or bfloat16")
    return getattr(torch, name)


def make_depth_model(config, *, seed: int = 0) -> nn.Module:
    """Build the network ``MODEL.depth_network`` selects, initialised from
    a seeded generator (on the CPU, so every device gets the same weights)."""
    kind = config.MODEL.depth_network
    if kind not in ("indoor", "monodepth2"):
        raise ValueError(f"{kind} is not a valid depth network option")
    dtype = compute_dtype(config)
    if kind == "indoor":
        model = DispResNetIndoor(num_layers=int(config.MODEL.num_layers), dtype=dtype)
    else:
        model = MonodepthNet(num_layers=int(config.MODEL.num_layers),
                             scales=tuple(config.DATA.scales), dtype=dtype)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model
