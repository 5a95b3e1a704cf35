"""ResNet encoder for depth estimation (NCHW inside, torchvision names).

The reference's ``ResnetEncoder`` (``depth_estimation/networks.py:16-104``):
ResNet 18/34/50 trunk, input normalisation ``(x - 0.45) / 0.225``, five
feature maps with channels ``[64, 64, 128, 256, 512]`` (x4 beyond 34
layers). Submodules carry torchvision's names (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer2.0.downsample.0`` ...), so ``state_dict()`` keys
are the reference checkpoints' keys.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

Tensor = torch.Tensor

# (block type, per-stage block counts)
RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
}


def encoder_channels(num_layers: int) -> List[int]:
    ch = [64, 64, 128, 256, 512]
    if num_layers > 34:
        ch = [ch[0]] + [c * 4 for c in ch[1:]]
    return ch


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, width, 3, stride)
        self.bn1 = _bn(width)
        self.conv2 = _conv(width, width, 3)
        self.bn2 = _bn(width)
        self.relu = nn.ReLU()
        self.downsample = None
        if stride != 1 or cin != width:
            self.downsample = nn.Sequential(_conv(cin, width, 1, stride), _bn(width))

    def forward(self, x: Tensor) -> Tensor:
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        cout = width * 4
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = _bn(width)
        self.conv2 = _conv(width, width, 3, stride)
        self.bn2 = _bn(width)
        self.conv3 = _conv(width, cout, 1)
        self.bn3 = _bn(cout)
        self.relu = nn.ReLU()
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride), _bn(cout))

    def forward(self, x: Tensor) -> Tensor:
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(out + identity)


class ResnetEncoder(nn.Module):
    """Five-scale ResNet feature extractor: NCHW images in [0, 1] ->
    five NCHW feature maps at strides 2/4/8/16/32."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 1):
        super().__init__()
        if num_layers not in RESNET_SPECS:
            raise ValueError(f"{num_layers} is not a valid ResNet depth")
        kind, stages = RESNET_SPECS[num_layers]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.num_ch_enc = encoder_channels(num_layers)
        self.conv1 = nn.Conv2d(3 * num_input_images, 64, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = _bn(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = 64
        for stage, (width, n) in enumerate(zip((64, 128, 256, 512), stages), start=1):
            blocks = []
            for b in range(n):
                stride = 2 if (stage > 1 and b == 0) else 1
                blocks.append(block(cin, width, stride))
                cin = width * block.expansion
            self.add_module(f"layer{stage}", nn.Sequential(*blocks))

    def forward(self, x: Tensor) -> List[Tensor]:
        x = (x - 0.45) / 0.225
        features = [self.relu(self.bn1(self.conv1(x)))]
        x = self.maxpool(features[-1])
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
            features.append(x)
        return features
