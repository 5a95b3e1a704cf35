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

The JAX package's own checkpoints (flax msgpack files) are not read here:
carry flax weights over with ``models/convert.py::load_jax_params``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Optional

import torch

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
    directory ``path``, onto the model's device whatever device saved it;
    returns the saved ``meta``."""
    if glob.glob(os.path.join(path, "*.msgpack")):
        raise ValueError(
            f"{path} holds flax msgpack files (a JAX package checkpoint); the port reads its "
            "own files only: carry flax weights over with "
            "e2eslam_tpu_torch/models/convert.py::load_jax_params")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    saved = set(manifest.get("files", []))
    if MODEL_FILE not in saved:
        raise FileNotFoundError(f"{path}: the manifest records no {MODEL_FILE}")
    device = next(model.parameters()).device
    model.load_state_dict(torch.load(os.path.join(path, MODEL_FILE), map_location=device,
                                     weights_only=True))
    opt_path = os.path.join(path, OPTIMIZER_FILE)
    if optimizer is not None and OPTIMIZER_FILE in saved and os.path.exists(opt_path):
        optimizer.load_state_dict(torch.load(opt_path, map_location=device, weights_only=True))
    return manifest.get("meta", {})
