"""Dataset construction and batching.

``make_dataset`` builds the dataset ``DATA.name`` selects: the synthetic
scene, or ICL-NUIM and TUM sequences from ``{DATA.data_path}/ICL`` and
``{DATA.data_path}/TUM`` (``DATA.trajectories`` picks trajectory
directories by name); ``load_batch`` stacks windows into numpy batches with
colors scaled to [0, 1] (the reference divides by 255 in every app).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def make_dataset(config, *, sequence_length: Optional[int] = None):
    """Build the dataset selected by ``DATA.name`` with reference knobs."""
    name = config.DATA.name
    seqlen = sequence_length or config.DEMO.sequence_length
    if name in ("ICL", "TUM"):
        from e2eslam_tpu_torch.data.tumicl import ICLDataset, TUMDataset

        # The reference's gradslam ``trajectories`` argument
        # (absolute_scale.py:81-88): one name or a list.
        trajectories = config.DATA.get("trajectories") or None
        if isinstance(trajectories, str):
            trajectories = [trajectories]
        cls = ICLDataset if name == "ICL" else TUMDataset
        return cls(basedir=f"{config.DATA.data_path}/{name}", seqlen=seqlen,
                   height=config.DATA.height, width=config.DATA.width,
                   dilation=config.DATA.dilation, stride=config.DATA.stride,
                   start=config.DATA.start, trajectories=trajectories)
    if name != "synthetic":
        raise ValueError(f"unknown dataset {name}")
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
