"""Save and restore the adapted network and its optimizer state.

The JAX package's checkpoint directory protocol (``e2eslam_tpu/checkpoint.py``)
with the port's own files: ``model.pt`` (``torch.save`` of the module's
state dict: parameters and batch-norm statistics), ``optimizer.pt`` (the
optimizer's state dict) and ``manifest.json`` (``{"files": [...], "meta":
{...}}``). A save deletes the old manifest first and writes the new one
last, atomically: a save cut short leaves no manifest, and a load without
one raises, instead of pairing new weights with an older optimizer state.
A load restores only the files the manifest records, and leaves what it
was not given (or the checkpoint lacks) as it is.

``load_checkpoint`` also reads the JAX package's directories: flax msgpack
files ``params.msgpack``, ``batch_stats.msgpack`` and ``opt_state.msgpack``
beside the same manifest, under its rules (the params always, the other two
where they exist and the manifest records them). The decoder is this
module's own (``msgpack_decode``: maps, strings, binaries, extensions,
integers, floats, arrays, nil, booleans; flax's ndarray extension, of
shape, dtype name and buffer, ``bfloat16`` included), so neither ``flax``
nor ``msgpack`` is needed. The trees go through
``models/convert.py::from_jax_params``; an optax Adam state (``count``,
``mu``, ``nu``, per parameter) becomes torch Adam's ``step``, ``exp_avg``
and ``exp_avg_sq``, matched by parameter name. Any other optimizer state
(SGD's trace, the fused-update layout's flat vectors) is refused, naming
what it holds. The learning-rate schedule's count is not restored, as for
the port's own checkpoints.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional

import torch

from e2eslam_tpu_torch.models.convert import from_jax_params

MODEL_FILE = "model.pt"
OPTIMIZER_FILE = "optimizer.pt"
MANIFEST = "manifest.json"


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write ``model`` (and ``optimizer``) into the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    manifest_path = os.path.join(path, MANIFEST)
    if os.path.exists(manifest_path):
        os.remove(manifest_path)
    manifest = {"files": [MODEL_FILE], "meta": meta or {}}
    torch.save(model.state_dict(), os.path.join(path, MODEL_FILE))
    if optimizer is not None:
        torch.save(optimizer.state_dict(), os.path.join(path, OPTIMIZER_FILE))
        manifest["files"].append(OPTIMIZER_FILE)
    tmp = manifest_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(tmp, manifest_path)
    return path


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> Dict[str, Any]:
    """Restore ``model`` (and ``optimizer``, when given and saved) from the
    directory ``path`` (the port's files or the JAX package's), onto the
    model's device whatever device saved it; returns the saved ``meta``."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    saved = set(manifest.get("files", []))
    if JAX_PARAMS in saved:
        _load_jax(path, saved, model, optimizer)
        return manifest.get("meta", {})
    if MODEL_FILE not in saved:
        raise FileNotFoundError(f"{path}: the manifest records no {MODEL_FILE}")
    device = next(model.parameters()).device
    model.load_state_dict(torch.load(os.path.join(path, MODEL_FILE), map_location=device,
                                     weights_only=True))
    opt_path = os.path.join(path, OPTIMIZER_FILE)
    if optimizer is not None and OPTIMIZER_FILE in saved and os.path.exists(opt_path):
        optimizer.load_state_dict(torch.load(opt_path, map_location=device, weights_only=True))
    return manifest.get("meta", {})


# ---------------------------------------------------------------------------
# the JAX package's checkpoints
# ---------------------------------------------------------------------------

JAX_PARAMS = "params.msgpack"
JAX_STATS = "batch_stats.msgpack"
JAX_OPT = "opt_state.msgpack"

# flax.serialization's extension types
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_DTYPES = {"float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "int8": torch.int8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
           "bool": torch.bool}


class _Reader:
    """msgpack's wire format, big-endian (msgpack spec, "formats")."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("msgpack: truncated input")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I"}  # bin 8/16/32
        if b in sized:
            return self.take(self.unpack(sized[b]))
        ext = {0xC7: "B", 0xC8: "H", 0xC9: "I"}  # ext 8/16/32
        if b in ext:
            n = self.unpack(ext[b])
            return _ext(self.unpack("b"), self.take(n))
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self.unpack("b")
            return _ext(code, self.take(1 << (b - 0xD4)))
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        strings = {0xD9: "B", 0xDA: "H", 0xDB: "I"}
        if b in strings:
            return self.take(self.unpack(strings[b])).decode()
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack("H" if b == 0xDC else "I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack("H" if b == 0xDE else "I"))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _ext(code: int, data: bytes):
    """flax's extensions: an ndarray (shape, dtype name, C-order buffer)
    as a CPU tensor, a NumPy scalar as a 0-d tensor."""
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"msgpack: extension type {code} is not a flax array")
    shape, name, buf = _Reader(data).value()
    name = name.decode() if isinstance(name, bytes) else name
    if name not in _DTYPES:
        raise ValueError(f"msgpack: array dtype {name!r} not supported")
    flat = torch.frombuffer(bytearray(buf), dtype=_DTYPES[name]) if buf else \
        torch.empty(0, dtype=_DTYPES[name])
    return flat.reshape(tuple(shape)).clone()


def msgpack_decode(data: bytes):
    """A flax msgpack file's tree: dicts of strings, arrays as CPU tensors;
    arrays that flax chunked (past 2^30 bytes) are joined again."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(data):
        raise ValueError("msgpack: trailing bytes")
    return _unchunk(tree)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if tree.get("__msgpack_chunked_array__"):
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def _read_tree(path: str, name: str):
    with open(os.path.join(path, name), "rb") as f:
        return msgpack_decode(f.read())


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.float().numpy() if torch.is_tensor(tree) else tree


def _load_jax(path: str, saved: set, model: torch.nn.Module,
              optimizer: Optional[torch.optim.Optimizer]) -> None:
    """The JAX package's files into ``model`` (and ``optimizer``)."""
    params = _read_tree(path, JAX_PARAMS)
    stats_path = os.path.join(path, JAX_STATS)
    stats = _read_tree(path, JAX_STATS) if (JAX_STATS in saved
                                            and os.path.exists(stats_path)) else {}
    update = from_jax_params(_to_numpy(params), _to_numpy(stats))
    own = model.state_dict()
    # Every parameter, and with the statistics file every statistic (the
    # batch-norm step counters excepted); without it they keep their values.
    required = [k for k, _ in model.named_parameters()]
    if stats:
        required += [k for k in own if k not in required
                     and not k.endswith("num_batches_tracked")]
    missing = [k for k in required if k not in update]
    unknown = sorted(set(update) - set(own))
    if unknown or missing:
        raise KeyError(f"{path}: missing {missing[:8]}, unexpected {unknown[:8]}")
    with torch.no_grad():
        for key, value in update.items():
            own[key].copy_(value)
    opt_path = os.path.join(path, JAX_OPT)
    if optimizer is not None and JAX_OPT in saved and os.path.exists(opt_path):
        _load_adam(_read_tree(path, JAX_OPT), model, optimizer, path)


def _adam_node(tree):
    """The ``{count, mu, nu}`` node of an optax Adam state (``optax.adam``
    chains it with the learning-rate scale), or None."""
    if isinstance(tree, dict):
        if set(tree) == {"count", "mu", "nu"} and isinstance(tree["mu"], dict):
            return tree
        for key in sorted(tree):
            found = _adam_node(tree[key])
            if found is not None:
                return found
    return None


def _describe(tree, depth=0) -> str:
    if not isinstance(tree, dict) or depth > 2:
        return "array" if torch.is_tensor(tree) else type(tree).__name__
    return "{" + ", ".join(f"{k}: {_describe(v, depth + 1)}" for k, v in tree.items()) + "}"


def _load_adam(tree, model: torch.nn.Module, optimizer: torch.optim.Optimizer, path: str):
    """An optax Adam state into torch's Adam: ``count`` -> ``step``,
    ``mu`` -> ``exp_avg``, ``nu`` -> ``exp_avg_sq``, per parameter name (the
    parameters the optimizer holds)."""
    node = _adam_node(tree)
    if node is None or not isinstance(optimizer, torch.optim.Adam):
        raise ValueError(
            f"{path}: the optimizer state is not an optax Adam state of per-parameter trees "
            f"(found {_describe(tree)}), or the optimizer ({type(optimizer).__name__}) is not "
            "torch.optim.Adam; only that pair is carried over")
    names = dict(model.named_parameters())
    group_of = {id(p): g for g in optimizer.param_groups for p in g["params"]}
    mu = from_jax_params(_to_numpy(node["mu"]), {})
    nu = from_jax_params(_to_numpy(node["nu"]), {})
    count = float(node["count"])
    for key, m in mu.items():
        p = names.get(key)
        if p is None:
            raise KeyError(f"{path}: Adam state for unknown parameter {key}")
        group = group_of.get(id(p))
        if group is None:
            continue  # a parameter this optimizer does not step (frozen batch norm)
        on_device = group.get("fused") or group.get("capturable")
        optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32,
                                 device=p.device if on_device else "cpu"),
            "exp_avg": m.to(p.device, p.dtype).clone(),
            "exp_avg_sq": nu[key].to(p.device, p.dtype).clone(),
        }
