"""The traffic generator: a cell's pool of sequences from its data file
and the seed.

A cell's file (``workloads/<cell>.json``) gives ``frames`` per sequence,
``n_seq`` sequences per unit, ``pool`` distinct units and the
``trajectory``; its configuration the size, the dilation and the first
frame ``DATA.start``. Sequence ``k`` of the pool starts at raw frame
``DATA.start + 7 k`` (the staggered starts of the port's
``apps/profile_adaptation.py::make_sequences``, after
tools/bench_batched.py), so unit ``u`` holds sequences ``u n_seq .. (u +
1) n_seq - 1``. The pool is the same for every seed: the seed sets the
order in which a window runs the units (``order``). Depth quality depends
on the part of the trajectory a sequence covers and on the weights, so a
pool drawn from the seed would spread abs_rel across seeds far wider than
across runs of one seed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from slambench import scene

def order(cell: Dict, seed: int) -> List[int]:
    """The pool's units in the order a run with ``seed`` takes them."""
    return [int(u) for u in np.random.default_rng(int(seed)).permutation(int(cell["pool"]))]


def pool_starts(cell: Dict, config: Dict) -> List[List[int]]:
    """Raw start frame of each sequence, per unit of the pool."""
    s0 = int(config["DATA"].get("start") or 0)
    n = int(cell["n_seq"])
    return [[s0 + 7 * (u * n + i) for i in range(n)] for u in range(int(cell["pool"]))]


def render_pool(cell: Dict, config: Dict, device) -> List[Dict[str, torch.Tensor]]:
    """Every sequence of the pool, rendered on ``device``: per unit a dict of
    stacked ``colors`` ``[n, L, H, W, 3]`` in [0, 1], ``depths``, ``K``
    ``[n, 4, 4]``, ``poses`` ``[n, L, 4, 4]``, the ``starts``, and
    ``colors255``, the colors times 255 as a dataset item holds them (a
    host array). ``colors`` is ``colors255 / 255`` divided on the host in
    float32, as the port's loader (``data/pipeline.py::load_batch``) hands
    a dataset's frames to the runner, so both sides see the same numbers
    (a division on the card multiplies by the reciprocal, which rounds
    otherwise)."""
    H, W = int(config["DATA"]["height"]), int(config["DATA"]["width"])
    dil = int(config["DATA"]["dilation"])
    units = []
    for starts in pool_starts(cell, config):
        seqs = [scene.sequence(s, int(cell["frames"]), dil, H, W,
                               trajectory=cell.get("trajectory", "arc"), device=device)
                for s in starts]
        colors255 = (torch.stack([c for c, _, _, _ in seqs]) * 255.0).cpu().numpy()
        colors = torch.from_numpy((colors255 / 255.0).astype(np.float32)).to(device)
        units.append({"colors": colors, "colors255": colors255,
                      "depths": torch.stack([d for _, d, _, _ in seqs]),
                      "K": torch.stack([k for _, _, k, _ in seqs]),
                      "poses": torch.stack([p for _, _, _, p in seqs]),
                      "starts": starts})
    return units
