"""The indoor depth network (``MODEL.depth_network: indoor``).

``DispResNetIndoor`` (reference ``networks.py:224-238``): ResNet encoder +
indoor decoder. Images enter NHWC ``[B, H, W, 3]`` in [0, 1] and the scale-0
disparity leaves NHWC ``[B, H, W, 1]``; the convolutions run NCHW inside.
Batch norm always runs in inference mode (the refinement freezes it, and
the JAX forward passes ``train=False``): the model is put in ``eval()`` at
construction and ``train()`` keeps it there.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from e2eslam_tpu_torch.models.decoders import IndoorDepthDecoder
from e2eslam_tpu_torch.models.resnet import ResnetEncoder

Tensor = torch.Tensor


class DispResNetIndoor(nn.Module):
    """ResNet encoder + indoor decoder; NHWC in, NHWC disparity out."""

    def __init__(self, num_layers: int = 18):
        super().__init__()
        self.encoder = ResnetEncoder(num_layers)
        self.decoder = IndoorDepthDecoder(self.encoder.num_ch_enc)
        self.eval()

    def train(self, mode: bool = True):
        # Batch norm stays in inference mode (frozen statistics).
        return super().train(False)

    def forward(self, x: Tensor) -> Tensor:
        features = self.encoder(x.permute(0, 3, 1, 2))
        return self.decoder(features).permute(0, 2, 3, 1)


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


def make_depth_model(config, *, seed: int = 0) -> DispResNetIndoor:
    """Build the network ``MODEL.depth_network`` selects, initialised from
    a seeded generator (on the CPU, so every device gets the same weights)."""
    kind = config.MODEL.depth_network
    if kind != "indoor":
        raise NotImplementedError(
            f"MODEL.depth_network {kind!r}: only 'indoor' is ported; "
            "MonodepthNet comes with a later slice of the port"
        )
    if str(config.SETTINGS.get("compute_dtype", "float32")) != "float32":
        raise NotImplementedError(
            "SETTINGS.compute_dtype: only float32 is ported; the bf16 "
            "flagship path comes with a later slice of the port"
        )
    model = DispResNetIndoor(num_layers=int(config.MODEL.num_layers))
    init_weights(model, torch.Generator().manual_seed(seed))
    return model
