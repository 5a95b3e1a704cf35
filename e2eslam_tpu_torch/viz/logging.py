"""Scalar logging and gradient observability.

The port of ``e2eslam_tpu/viz/logging.py`` (the reference's tensorboardX
backward-hook machinery, ``train_depth.py:138-169`` and ``:865-917``):
gradients are read from the parameters' ``.grad`` (``named_parameters``)
or from the engine's gradient dict, and the decoder's activation gradients
from its taps, so no hook is needed. Scalars land in a JSONL file, and in
tensorboardX too when it imports.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Mapping

import numpy as np
import torch


class ScalarLogger:
    """Append-only JSONL scalar log, one line per ``log`` call."""

    def __init__(self, log_dir: str, name: str = "scalars"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._fh = open(self.path, "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter  # optional

            self._tb = SummaryWriter(log_dir)
        except ImportError:
            pass

    def log(self, step: int, scalars: Mapping[str, float], prefix: str = ""):
        record = {"step": step, "time": time.time()}
        for key, value in scalars.items():
            name = f"{prefix}{key}"
            record[name] = float(value)
            if self._tb is not None:
                self._tb.add_scalar(name, float(value), step)
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()
        if self._tb is not None:
            self._tb.close()


def write_histograms(hists: Dict[str, Dict], logger: ScalarLogger, *,
                     step: int, prefix: str = "grad/") -> None:
    """Persist per-layer gradient histograms: tensorboardX
    ``add_histogram_raw`` records when it imports (the reference's sink),
    else the counts and edges in a JSONL beside the scalar log."""
    if logger is None:
        return
    if logger._tb is not None:
        for name, h in hists.items():
            logger._tb.add_histogram_raw(
                f"{prefix}{name}",
                min=float(h["edges"][0]),
                max=float(h["edges"][-1]),
                num=int(h["hist"].sum()),
                sum=float(h.get("sum", 0.0)),
                sum_squares=float(h.get("sum_sq", h["norm"] ** 2)),
                bucket_limits=[float(e) for e in h["edges"][1:]],
                bucket_counts=[int(c) for c in h["hist"]],
                global_step=step,
            )
        return
    path = logger.path.replace(".jsonl", "_grad_hists.jsonl")
    with open(path, "a") as f:
        for name, h in hists.items():
            f.write(json.dumps({
                "step": step,
                "layer": f"{prefix}{name}" if prefix != "grad/" else name,
                "hist": [int(c) for c in h["hist"]],
                "edges": [float(e) for e in h["edges"]],
                "norm": h["norm"],
            }) + "\n")


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()
    return np.asarray(value)


def gradient_histograms(grads: Mapping, *, bins: int = 64) -> Dict[str, Dict]:
    """Per-layer histograms of gradients, on the host.

    ``grads``: a mapping ``{name: tensor or array}`` (the engine's
    parameter gradients by ``named_parameters`` name, the decoder's
    activation gradients by tap). Returns ``{name:
    {"hist", "edges", "norm", "sum", "sum_sq"}}``, in the order of the names
    (a JAX pytree's flattening order). Non-finite values are left out
    (``np.histogram`` refuses them); a layer with none finite gets an empty
    histogram."""
    out = {}
    for name in sorted(grads):
        arr = _host(grads[name]).ravel()
        finite = arr[np.isfinite(arr)]
        if finite.size:
            hist, edges = np.histogram(finite, bins=bins)
        else:
            hist = np.zeros(bins, dtype=np.int64)
            edges = np.linspace(0.0, 1.0, bins + 1)
        out[name] = {
            "hist": hist,
            "edges": edges,
            "norm": float(np.linalg.norm(finite)),
            "sum": float(finite.sum()),
            "sum_sq": float(np.dot(finite, finite)),
        }
    return out
