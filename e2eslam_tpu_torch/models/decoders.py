"""The indoor U-Net depth decoder (NCHW inside).

The reference's indoor decoder (``depth_estimation/networks.py:241-292``):
per level ``upconv0 -> nearest 2x upsample -> concat skip -> upconv1``,
decoder channels ``[16, 32, 64, 128, 256]``, reflection-padded 3x3 convs +
ELU, disparity ``10 * sigmoid + 0.01`` at scale 0 only. The decoder is a
``ModuleList`` indexed as the reference's: ``upconv_{i}_{j}`` at
``(4 - i) * 2 + j`` and ``dispconv_{s}`` at ``10 + s`` (all four heads
exist, as in the reference checkpoints; only scale 0 runs).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

DECODER_CHANNELS = (16, 32, 64, 128, 256)


class Conv3x3(nn.Module):
    """Reflection-padded 3x3 convolution."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.pad = nn.ReflectionPad2d(1)
        self.conv = nn.Conv2d(cin, cout, 3)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(self.pad(x))


class ConvBlock(nn.Module):
    """Conv3x3 followed by ELU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv3x3(cin, cout)
        self.nonlin = nn.ELU()

    def forward(self, x: Tensor) -> Tensor:
        return self.nonlin(self.conv(x))


class IndoorDepthDecoder(nn.ModuleList):
    """``alpha * sigmoid + beta`` disparity at scale 0 (alpha 10, beta 0.01)."""

    alpha = 10.0
    beta = 0.01

    def __init__(self, num_ch_enc: Sequence[int], use_skips: bool = True):
        modules: List[nn.Module] = []
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else DECODER_CHANNELS[i + 1]
            modules.append(ConvBlock(cin, DECODER_CHANNELS[i]))
            cin = DECODER_CHANNELS[i]
            if use_skips and i > 0:
                cin += num_ch_enc[i - 1]
            modules.append(ConvBlock(cin, DECODER_CHANNELS[i]))
        for s in range(4):
            modules.append(Conv3x3(DECODER_CHANNELS[s], 1))
        super().__init__(modules)
        self.use_skips = use_skips

    def forward(self, features: Sequence[Tensor]) -> Tensor:
        x = features[-1]
        for i in range(4, -1, -1):
            x = self[(4 - i) * 2](x)
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            if self.use_skips and i > 0:
                x = torch.cat([x, features[i - 1]], dim=1)
            x = self[(4 - i) * 2 + 1](x)
        return self.alpha * torch.sigmoid(self[10](x)) + self.beta
