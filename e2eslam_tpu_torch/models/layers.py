"""Convolution and frozen batch norm that compute in their input's dtype.

``SETTINGS.compute_dtype: bfloat16`` works as flax's ``dtype`` does: the
parameters stay float32 and each layer casts them to the activations'
dtype (``flax.linen.Conv``: inputs, kernel and bias promoted to ``dtype``,
the bias added after the convolution). Batch norm computes in float32
against its float32 statistics and casts its output back
(``flax.linen.normalization._normalize``: ``(x - mean) * (rsqrt(var + eps)
* scale) + bias``). Gradients reach the float32 parameters through the
casts. In float32 both layers are torch's own.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


@functools.lru_cache(maxsize=None)
def constant(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as flax casts a Python constant to
    its operand's dtype (a weak type). A host float: no device copy."""
    return float(torch.tensor(value, dtype=dtype))


class Conv2d(nn.Conv2d):
    def forward(self, x: Tensor) -> Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding,
                     self.dilation, self.groups)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype).view(1, -1, 1, 1)
        return y


class BatchNorm2d(nn.BatchNorm2d):
    """Batch norm in inference mode (the port never trains statistics)."""

    def forward(self, x: Tensor) -> Tensor:
        if x.dtype == self.running_mean.dtype:
            return super().forward(x)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)
