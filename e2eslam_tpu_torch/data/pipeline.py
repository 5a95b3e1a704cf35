"""Dataset construction and batching (synthetic sequences).

``make_dataset`` builds the dataset ``DATA.name`` selects; ``load_batch``
stacks windows into numpy batches with colors scaled to [0, 1] (the
reference divides by 255 in every app). The ICL/TUM disk loaders are not
ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def make_dataset(config, *, sequence_length: Optional[int] = None):
    """Build the dataset selected by ``DATA.name`` with reference knobs."""
    name = config.DATA.name
    seqlen = sequence_length or config.DEMO.sequence_length
    if name != "synthetic":
        raise NotImplementedError(
            f"DATA.name {name!r}: only the synthetic dataset is ported; the "
            "ICL/TUM loaders come with a later slice of the port"
        )
    from e2eslam_tpu_torch.data.synthetic import SyntheticDataset

    total = (config.DATA.start or 0) + seqlen * ((config.DATA.dilation or 0) + 1) + 8
    return SyntheticDataset(
        total_frames=total,
        seqlen=seqlen,
        height=config.DATA.height,
        width=config.DATA.width,
        dilation=config.DATA.dilation,
        stride=config.DATA.stride,
        start=config.DATA.start,
        textureless_frac=float(config.DATA.get("textureless_frac") or 0.0),
        photo_jitter=float(config.DATA.get("photo_jitter") or 0.0),
        trajectory=str(config.DATA.get("trajectory") or "arc"),
        textureless_spheres=bool(config.DATA.get("textureless_spheres") or False),
    )


def load_batch(dataset, indices: Sequence[int]):
    """Stack windows into a [B, ...] numpy batch.

    Returns (colors [B,L,H,W,3] in [0,1], depths [B,L,H,W,1],
    intrinsics [B,4,4], poses [B,L,4,4], transforms [B,L,4,4]), float32.
    """
    items = [dataset[i] for i in indices]
    colors = np.stack([it[0] for it in items]) / 255.0
    depths = np.stack([it[1] for it in items])
    intrinsics = np.stack([it[2] for it in items])
    poses = np.stack([it[3] for it in items])
    transforms = np.stack([it[4] for it in items])
    return (
        colors.astype(np.float32),
        depths.astype(np.float32),
        intrinsics.astype(np.float32),
        poses.astype(np.float32),
        transforms.astype(np.float32),
    )
