"""The U-Net depth decoders (NCHW inside).

The reference's decoders (``depth_estimation/networks.py:107-154`` and
``:241-292``): per level ``upconv0 -> nearest 2x upsample -> concat skip ->
upconv1``, decoder channels ``[16, 32, 64, 128, 256]``, reflection-padded
3x3 convs + ELU. The indoor decoder's disparity is ``10 * sigmoid + 0.01``
at scale 0 only; the monodepth2 decoder's is a sigmoid at every scale of
``DATA.scales``. Each decoder is a ``ModuleList`` indexed as the
reference's: ``upconv_{i}_{j}`` at ``(4 - i) * 2 + j`` and ``dispconv_{s}``
at ``10 + s`` (the indoor decoder has all four heads, as in the reference
checkpoints; only scale 0 runs). The decoders compute in their input
features' dtype (``models/layers.py``).

``taps`` (``e2eslam_tpu/models/decoders.py:88-110``): optional zero
tensors added to the ten decoder conv outputs ``upconv_{i}_{0,1}`` (NCHW,
shapes from ``decoder_tap_shapes``); their gradients are the loss's
gradients with respect to those activations, the reference's backward
hooks (``train_depth.py:138-168``) as plain tensors.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from e2eslam_tpu_torch.models.layers import Conv2d, constant

Tensor = torch.Tensor

DECODER_CHANNELS = (16, 32, 64, 128, 256)


class Conv3x3(nn.Module):
    """Reflection-padded 3x3 convolution."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.pad = nn.ReflectionPad2d(1)
        self.conv = Conv2d(cin, cout, 3)

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


class _UNetDecoder(nn.ModuleList):
    """The U-Net both decoders share (``e2eslam_tpu/models/decoders.py:65``):
    ``upconv_{i}_{j}`` at index ``(4 - i) * 2 + j`` and one disparity head
    per scale of ``head_scales`` from index 10 (the reference's ``ModuleList``
    order). ``forward`` returns ``{scale: disparity NCHW}`` for ``scales``
    (default: every scale of ``emit_scales``), computing only those heads."""

    emit_scales: Sequence[int] = (0,)

    def __init__(self, num_ch_enc: Sequence[int], head_scales: Sequence[int],
                 use_skips: bool = True):
        modules: List[nn.Module] = []
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else DECODER_CHANNELS[i + 1]
            modules.append(ConvBlock(cin, DECODER_CHANNELS[i]))
            cin = DECODER_CHANNELS[i]
            if use_skips and i > 0:
                cin += num_ch_enc[i - 1]
            modules.append(ConvBlock(cin, DECODER_CHANNELS[i]))
        for s in head_scales:
            modules.append(Conv3x3(DECODER_CHANNELS[s], 1))
        super().__init__(modules)
        self.use_skips = use_skips
        self.head_scales = tuple(int(s) for s in head_scales)

    def head(self, x: Tensor) -> Tensor:
        raise NotImplementedError

    def forward(self, features: Sequence[Tensor], scales=None,
                taps: Optional[Dict[str, Tensor]] = None) -> Dict[int, Tensor]:
        scales = self.emit_scales if scales is None else scales
        outputs: Dict[int, Tensor] = {}
        x = features[-1]
        for i in range(4, -1, -1):
            x = self[(4 - i) * 2](x)
            if taps is not None:
                x = x + taps[f"upconv_{i}_0"]
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            if self.use_skips and i > 0:
                x = torch.cat([x, features[i - 1]], dim=1)
            x = self[(4 - i) * 2 + 1](x)
            if taps is not None:
                x = x + taps[f"upconv_{i}_1"]
            if i in scales and i in self.head_scales:
                outputs[i] = self.head(self[10 + self.head_scales.index(i)](x))
        return outputs


class IndoorDepthDecoder(_UNetDecoder):
    """``alpha * sigmoid + beta`` disparity at scale 0 (alpha 10, beta 0.01);
    all four heads exist, as in the reference checkpoints."""

    alpha = 10.0
    beta = 0.01

    def __init__(self, num_ch_enc: Sequence[int], use_skips: bool = True):
        super().__init__(num_ch_enc, (0, 1, 2, 3), use_skips)

    def head(self, x: Tensor) -> Tensor:
        return self.alpha * torch.sigmoid(x) + constant(self.beta, x.dtype)


class DepthDecoder(_UNetDecoder):
    """The monodepth2 decoder: a sigmoid disparity head at every scale of
    ``scales`` (``DATA.scales``), each emitted."""

    def __init__(self, num_ch_enc: Sequence[int], scales: Sequence[int] = (0, 1, 2, 3),
                 use_skips: bool = True):
        scales = tuple(int(s) for s in scales)
        if scales != tuple(range(len(scales))):
            # The weight bridge maps dispconv_{s} to index 10 + s, so the
            # heads must be the scales 0..n-1 in order.
            raise ValueError(f"DATA.scales must be 0..n-1 in order, got {list(scales)}")
        super().__init__(num_ch_enc, scales, use_skips)
        self.emit_scales = scales

    def head(self, x: Tensor) -> Tensor:
        return torch.sigmoid(x)


def decoder_tap_shapes(batch: int, height: int, width: int) -> Dict[str, tuple]:
    """NCHW shapes of the ten decoder conv outputs (the taps):
    ``upconv_{i}_0`` at 1/2^(i+1) of the input's size (before the
    upsample), ``upconv_{i}_1`` at 1/2^i (``e2eslam_tpu/models/decoders.py:146``,
    which gives them NHWC)."""
    shapes = {}
    for i in range(4, -1, -1):
        c = DECODER_CHANNELS[i]
        shapes[f"upconv_{i}_0"] = (batch, c, height // 2 ** (i + 1), width // 2 ** (i + 1))
        shapes[f"upconv_{i}_1"] = (batch, c, height // 2 ** i, width // 2 ** i)
    return shapes
