"""Dataset construction and batching.

``make_dataset`` builds the dataset ``DATA.name`` selects: the synthetic
scene, or ICL-NUIM and TUM sequences from ``{DATA.data_path}/ICL`` and
``{DATA.data_path}/TUM`` (``DATA.trajectories`` picks trajectory
directories by name); ``load_batch`` stacks windows into numpy batches with
colors scaled to [0, 1] (the reference divides by 255 in every app);
``prefetch_batches`` decodes them on background threads, in order.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch


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


def load_batch(dataset, indices: Sequence[int], device=None):
    """Stack windows into a [B, ...] numpy batch (tensors on ``device`` when
    one is given).

    Returns (colors [B,L,H,W,3] in [0,1], depths [B,L,H,W,1],
    intrinsics [B,4,4], poses [B,L,4,4], transforms [B,L,4,4]), float32.
    """
    items = [dataset[i] for i in indices]
    colors = np.stack([it[0] for it in items]) / 255.0
    depths = np.stack([it[1] for it in items])
    intrinsics = np.stack([it[2] for it in items])
    poses = np.stack([it[3] for it in items])
    transforms = np.stack([it[4] for it in items])
    batch = tuple(x.astype(np.float32) for x in (colors, depths, intrinsics, poses, transforms))
    if device is not None:
        batch = tuple(torch.from_numpy(x).to(device) for x in batch)
    return batch


def prefetch_batches(dataset, batch_indices: Iterable[Sequence[int]], *, num_threads: int = 1,
                     capacity: int = 2, device=None) -> Iterator:
    """``load_batch`` of each entry of ``batch_indices``, decoded ahead on
    ``num_threads`` background threads (round-robin over the entries) and
    yielded in order; a worker's exception is raised by the iterator.
    ``num_threads`` 0 decodes in the caller's thread. At most
    ``max(capacity, num_threads)`` decoded batches wait in the queue."""
    if num_threads <= 0:
        for idxs in batch_indices:
            yield load_batch(dataset, idxs, device=device)
        return
    indexed = list(enumerate(batch_indices))
    q: queue.Queue = queue.Queue(maxsize=max(capacity, num_threads))
    workers = int(num_threads)

    def worker(shard: int):
        try:
            for pos, idxs in indexed[shard::workers]:
                q.put((pos, load_batch(dataset, idxs, device=device)))
        except BaseException as exc:  # raised by the consumer
            q.put((None, exc))

    for w in range(workers):
        threading.Thread(target=worker, args=(w,), daemon=True).start()
    pending = {}
    for pos in range(len(indexed)):
        while pos not in pending:
            got, item = q.get()
            if got is None:
                raise item
            pending[got] = item
        yield pending.pop(pos)


class ArrayDataset:
    """One window: a whole sequence held in memory (colors ``[L, H, W, 3]``
    in [0, 1], depths ``[L, H, W, 1]``, intrinsics ``[4, 4]``, poses ``[L,
    4, 4]``), in the datasets' item layout (colors in [0, 255]), for a
    runner's ``dataset`` argument."""

    def __init__(self, colors01, depths, intrinsics, poses):
        poses = np.asarray(poses, np.float32)
        self._item = (np.asarray(colors01, np.float32) * 255.0, np.asarray(depths, np.float32),
                      np.asarray(intrinsics, np.float32), poses,
                      np.broadcast_to(np.eye(4, dtype=np.float32), poses.shape).copy())

    def __len__(self):
        return 1

    def __getitem__(self, i):
        return self._item
