"""The weight bridge: flax parameter trees -> the port's ``state_dict``.

The JAX package names its flax modules so that each parameter maps to a
reference torch key (its ``models/convert.py::_torch_key``); this module
keeps its own copy of that mapping and applies it in the direction the
port needs. Inputs are nested dicts of numpy arrays (``params`` and
``batch_stats`` as flax returns them, moved to the host).

  conv kernel ``[kh, kw, I, O]`` -> weight ``[O, I, kh, kw]``
  batch norm ``scale/bias`` -> ``weight/bias``; ``mean/var`` ->
  ``running_mean/running_var``
  decoder ``upconv_{i}_{j}`` -> ``decoder.{(4 - i) * 2 + j}.conv.conv``,
  ``dispconv_{s}`` -> ``decoder.{10 + s}.conv``
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_BN_LEAF_MAP = {
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def torch_key(path: Tuple[str, ...], collection: str) -> str:
    """Map a flax parameter path to the reference torch key."""
    parts = list(path)
    leaf = parts[-1]
    if parts[0] == "encoder":
        segs = []
        for seg in parts[1:-1]:
            m = re.fullmatch(r"layer(\d)_(\d+)", seg)
            if m:
                segs.append(f"layer{m.group(1)}.{m.group(2)}")
            elif seg == "downsample_conv":
                segs.append("downsample.0")
            elif seg == "downsample_bn":
                segs.append("downsample.1")
            else:
                segs.append(seg)
        if collection == "batch_stats" or leaf == "scale":
            suffix = _BN_LEAF_MAP[leaf]
        elif leaf == "kernel":
            suffix = "weight"
        elif leaf == "bias":
            suffix = "bias"  # encoder convs have no bias: this is batch norm
        else:
            raise KeyError(f"unexpected leaf {leaf} at {path}")
        return "encoder." + ".".join(segs) + "." + suffix
    if parts[0] == "decoder":
        seg = parts[1]
        m = re.fullmatch(r"upconv_(\d)_(\d)", seg)
        if m:
            idx = (4 - int(m.group(1))) * 2 + int(m.group(2))
            mid = "conv.conv"
        else:
            m = re.fullmatch(r"dispconv_(\d)", seg)
            if not m:
                raise KeyError(f"unexpected decoder module {seg}")
            idx = 10 + int(m.group(1))
            mid = "conv"
        suffix = "weight" if leaf == "kernel" else "bias"
        return f"decoder.{idx}.{mid}.{suffix}"
    raise KeyError(f"unexpected top-level module {parts[0]}")


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def from_jax_params(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``params``/``batch_stats`` trees -> a ``state_dict`` of the port's
    ``DispResNetIndoor`` (without the ``num_batches_tracked`` counters)."""
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in (("params", params), ("batch_stats", batch_stats or {})):
        for path, value in _flatten(tree):
            value = np.asarray(value, np.float32)
            if path[-1] == "kernel":
                value = value.transpose(3, 2, 0, 1)
            out[torch_key(path, collection)] = torch.from_numpy(np.array(value))
    return out


def load_jax_params(model: torch.nn.Module, params: Mapping,
                    batch_stats: Mapping) -> None:
    """Load flax trees into ``model``; every parameter and statistic must be
    covered (only the batch-norm step counters are absent)."""
    missing, unexpected = model.load_state_dict(
        from_jax_params(params, batch_stats), strict=False
    )
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"missing {missing[:8]}, unexpected {unexpected[:8]}")
