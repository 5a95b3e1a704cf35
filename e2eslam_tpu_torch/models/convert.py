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

The indoor and the monodepth2 networks share these keys (their decoders
differ only in the disparity heads' activation and count).

The reference's torch checkpoints (``train_depth.py:798-845``) load through
the same keys (``load_depth_weights``): the indoor network's single
``depth.pth.tar``, whose ``state_dict`` nests the torchvision net and the
decoder's ModuleList once more (``encoder.encoder.*``,
``decoder.decoder.*``), monodepth2's per-module ``{name}.pth`` files
(``encoder.pth`` with ``height``/``width``/``use_stereo`` entries to drop),
and a bare torchvision ResNet state dict for the ImageNet encoder.
"""

from __future__ import annotations

import os
import re
import warnings
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
    ``DispResNetIndoor`` or ``MonodepthNet`` (without the
    ``num_batches_tracked`` counters)."""
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


_JUNK_KEYS = ("height", "width", "use_stereo")


def _canonicalize(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A reference state dict's keys as the port's ``encoder.<torchname>`` /
    ``decoder.<idx>...``: junk entries and batch-norm step counters dropped,
    ``module.`` stripped, the full network's second nesting undone, bare
    torchvision keys prefixed with ``encoder.``
    (e2eslam_tpu/models/convert.py:36-58)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        if key in _JUNK_KEYS or key.endswith("num_batches_tracked"):
            continue
        k = key[len("module."):] if key.startswith("module.") else key
        if k.startswith("encoder.encoder."):
            k = "encoder." + k[len("encoder.encoder."):]
        elif k.startswith("decoder.decoder."):
            k = "decoder." + k[len("decoder.decoder."):]
        elif re.match(r"^(conv1|bn1|layer\d)\.", k):
            k = "encoder." + k  # a bare torchvision state dict
        out[k] = torch.as_tensor(np.asarray(value.detach().cpu() if hasattr(value, "detach")
                                            else value))
    return out


def _convert(value: torch.Tensor, target: torch.Tensor, key: str) -> torch.Tensor:
    """``value`` in ``target``'s shape, float32. A single-image stem conv
    ``[O, I, kh, kw]`` filling a multi-image one is replicated over the
    stacked inputs and renormalised (reference ``resnet_multiimage_input``,
    networks.py:101)."""
    if value.dim() == 4 and target.dim() == 4:
        tin, vin = target.shape[1], value.shape[1]
        if tin != vin and tin % vin == 0 and value.shape[2:] == target.shape[2:]:
            value = torch.cat([value] * (tin // vin), dim=1) / (tin // vin)
    if tuple(value.shape) != tuple(target.shape):
        raise ValueError(f"shape mismatch loading {key}: checkpoint {tuple(value.shape)} vs "
                         f"model {tuple(target.shape)}")
    return value.to(torch.float32)


def load_state_dict_into(model: torch.nn.Module, state_dict: Mapping, *,
                         strict: bool = False, expect_full: bool = False) -> int:
    """Merge a reference torch state dict into ``model``: every parameter and
    statistic whose canonical key the file holds is replaced, the rest keep
    their values (the reference's partial ``load_model`` merge). Returns the
    number of entries loaded.

    ``strict``: a missed entry or an unused key raises. Otherwise a file that
    matches nothing warns (a wrong or corrupt checkpoint would leave the
    network at its initialisation), and with ``expect_full`` (a whole-network
    checkpoint such as the indoor ``depth.pth.tar``) so does any missed entry
    (e2eslam_tpu/models/convert.py:185-200)."""
    src = _canonicalize(state_dict)
    own = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    used, missed = [], []
    update = {}
    for key, target in own.items():
        if key in src:
            update[key] = _convert(src[key], target, key)
            used.append(key)
        else:
            missed.append(key)
    if strict:
        if missed:
            raise KeyError(f"missing checkpoint keys: {missed[:8]}")
        unused = sorted(set(src) - set(used))
        if unused:
            raise KeyError(f"unconsumed checkpoint keys: {unused[:8]} ...")
    elif not used and src:
        warnings.warn(f"checkpoint matched 0 model leaves (of {len(missed)}); the model stays "
                      "at its random initialization -- wrong or corrupt checkpoint file?")
    elif expect_full and missed:
        warnings.warn(f"full-model checkpoint left {len(missed)} leaves at initialization "
                      f"(e.g. {missed[:5]}); the file may be stale or from a different "
                      "architecture")
    with torch.no_grad():
        state = model.state_dict()
        for key, value in update.items():
            state[key].copy_(value)
    return len(used)


def load_torch_checkpoint(path: str, model: torch.nn.Module, *, strict: bool = False,
                          expect_full: bool = False) -> int:
    """Load a reference ``.pth`` / ``.pth.tar`` file into ``model`` (its
    ``state_dict`` entry when it has one)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return load_state_dict_into(model, ckpt, strict=strict, expect_full=expect_full)


def load_monodepth2_modules(dirpath: str, model: torch.nn.Module,
                            models_to_load=("encoder", "depth")) -> None:
    """monodepth2's per-module files ``{dirpath}/{name}.pth``, merged in
    turn (reference train_depth.py:798-822)."""
    for name in models_to_load:
        load_torch_checkpoint(os.path.join(dirpath, f"{name}.pth"), model)


def load_imagenet_encoder(path: str, model: torch.nn.Module) -> int:
    """The encoder from a torchvision ResNet state dict on disk (the
    reference downloads it, networks.py:34-47; there is no network here).
    The decoder keeps its initialisation."""
    return load_torch_checkpoint(path, model)


def save_reference_checkpoint(model: torch.nn.Module, dirpath: str) -> str:
    """Write ``model`` as the reference's indoor ``depth.pth.tar`` (its
    state dict under ``state_dict``, the torchvision net and the decoder's
    ModuleList nested once more), the file ``load_depth_weights`` reads.
    Returns the file's path."""
    nested = {}
    for key, value in model.state_dict().items():
        part, rest = key.split(".", 1)
        nested[f"{part}.{part}.{rest}"] = value.detach().cpu()
    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(dirpath, "depth.pth.tar")
    torch.save({"state_dict": nested}, path)
    return path


def load_depth_weights(config, model: torch.nn.Module) -> None:
    """Every app's weight loading, in the reference's order
    (e2eslam_tpu/models/convert.py:241-304): the ImageNet encoder
    (``MODEL.weights_init_encoder: imagenet`` with
    ``MODEL.imagenet_weights_path``), then the task checkpoint
    (``MODEL.use_pretrained_models`` with ``MODEL.load_depth_path``): the
    indoor network's ``depth.pth.tar``, or monodepth2's per-module files named
    by ``MODEL.models_to_load``, else ``MODEL.pretrained_models_list``, else
    ``encoder`` and ``depth``."""
    M = config.MODEL
    if str(M.get("weights_init_encoder") or "").lower() == "imagenet":
        path = M.get("imagenet_weights_path")
        if not path:
            raise ValueError(
                "MODEL.weights_init_encoder: imagenet requires MODEL.imagenet_weights_path "
                "(a torchvision ResNet state dict on disk; nothing is downloaded)")
        load_imagenet_encoder(path, model)
    if M.get("use_pretrained_models") and M.get("load_depth_path"):
        if str(M.get("depth_network", "indoor")) == "indoor":
            load_torch_checkpoint(os.path.join(M.load_depth_path, "depth.pth.tar"), model,
                                  expect_full=True)
        else:
            names = tuple(M.get("models_to_load") or M.get("pretrained_models_list")
                          or ("encoder", "depth"))
            load_monodepth2_modules(M.load_depth_path, model, models_to_load=names)
