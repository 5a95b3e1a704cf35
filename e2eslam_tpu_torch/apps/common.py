"""What the offline apps share: the device and the network, a dataset
window on the device, and metrics on the host.

Every app runs on CUDA unless ``SETTINGS.device`` (or the caller's
``device``) says ``cpu`` (``device.resolve_device``). The network is the
seeded initialisation (or the caller's ``model``), then the configured
weights (``models/convert.py::load_depth_weights``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from e2eslam_tpu_torch.data.pipeline import load_batch
from e2eslam_tpu_torch.device import resolve_device, set_full_fp32
from e2eslam_tpu_torch.engine.refine import PairBatch
from e2eslam_tpu_torch.models.convert import load_depth_weights
from e2eslam_tpu_torch.models.depth_net import make_depth_model


def device_and_model(config, device=None, model: Optional[torch.nn.Module] = None):
    """(device, network with the configured weights)."""
    dev = resolve_device(device, config)
    set_full_fp32()
    model = model if model is not None else make_depth_model(config)
    load_depth_weights(config, model)
    return dev, model.to(dev)


def window(dataset, index: int, device) -> PairBatch:
    """Window ``index`` of ``dataset`` as a PairBatch on ``device``."""
    colors, gt_depths, intrinsics, poses, _ = load_batch(dataset, [index])
    return PairBatch(colors=torch.from_numpy(colors[0]).to(device),
                     gt_depths=torch.from_numpy(gt_depths[0]).to(device),
                     intrinsics=torch.from_numpy(intrinsics[0]).to(device),
                     poses=torch.from_numpy(poses[0]).to(device))


def synchronize(device) -> None:
    """Wait for the card's queued work (host clocks around device work)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_scalars(metrics: Dict) -> Dict[str, float]:
    """The 0-d entries of a metrics dict as floats (nested payloads, such as
    ``grad_norms`` or ``debug_images``, left out)."""
    return {k: float(v) for k, v in metrics.items()
            if isinstance(v, (int, float)) or (isinstance(v, torch.Tensor) and v.ndim == 0)}
