"""Offline median-scale estimation over a trajectory.

    python -m e2eslam_tpu_torch.apps.median_scaling --config_path CONFIG

The port of ``e2eslam_tpu/apps/median_scaling.py`` (the reference's
``find_median_scale``, ``median_scaling.py:138-215``): per window, ``ratio =
median(gt depths) / median(predicted depths)``, with ``jnp.median``'s
meaning (the mean of the two middle values for an even count; the engine's
``_median``); the scale is the median of the ratios. Inference only: the
ratios stay on the device and come to the host once.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from e2eslam_tpu_torch.apps.common import device_and_model, window
from e2eslam_tpu_torch.config import load_config
from e2eslam_tpu_torch.core.depth import disp_to_depth, indoor_disp_to_depth
from e2eslam_tpu_torch.data.pipeline import make_dataset
from e2eslam_tpu_torch.engine.refine import _median


def find_median_scale(config, *, dataset=None, max_windows: Optional[int] = None,
                      device=None, model=None) -> float:
    dataset = dataset if dataset is not None else make_dataset(
        config, sequence_length=len(config.DATA.frames))
    dev, model = device_and_model(config, device, model)
    n = len(dataset) if max_windows is None else min(len(dataset), max_windows)
    ratios = []
    with torch.no_grad():
        for i in range(n):
            pair = window(dataset, i, dev)
            disp = model(pair.colors).float()
            if config.MODEL.depth_network == "indoor":
                depth = indoor_disp_to_depth(disp)
            else:
                depth = disp_to_depth(disp, float(config.DATA.min_depth),
                                      float(config.DATA.max_depth))
            ratios.append(_median(pair.gt_depths) / _median(depth))
    return float(np.median(torch.stack(ratios).cpu().numpy()))


def main(argv=None):
    config = load_config(argv)
    scale = find_median_scale(config)
    print(f"median depth scale: {scale:.4f}")
    return scale


if __name__ == "__main__":
    main()
