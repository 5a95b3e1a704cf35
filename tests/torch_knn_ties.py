"""Exact-tie inputs for the resident KNN kernel's tests (CPU and card):
refs and queries on a quarter-unit grid, so every float32 score is exact and
the kernels, their plain versions and any split of the walk must agree bit
for bit."""

import numpy as np
import torch


def grid_tie_refs(rng, st, n_sub, nq_tiles, qt):
    """Refs and queries on a grid of quarter units, so every score is exact
    in float32 whatever the summation order, and exact ties abound.
    Sub-tile s holds points with x in [3s, 3s + 1]. Sub-tile 2 keeps its
    rows at x = 7 (its right face, all nine (y, z) in 1/4..3/4 among them)
    in its first half, which sub-tile 6 repeats; one row of sub-tile 4
    repeats another. Query tile 0 sits at x = 7.25 (its first 40 rows at
    y = z = 1/4, tied with row 2 st), outside sub-tile 2's box but inside
    sub-tile 6's, so its list starts at sub-tile 6 and its ties go to 6;
    query tile 1 sits inside sub-tile 2, whose list starts there (the
    lower of two zero gaps); the rest are spread. Returns ``q4
    [nq_tiles * qt, 4]`` and ``r4 [n_sub * st, 4]`` as the kernels take them."""
    r = np.stack([rng.integers(0, 5, n_sub * st) / 4 + 3 * np.repeat(np.arange(n_sub), st),
                  rng.integers(0, 5, n_sub * st) / 4,
                  rng.integers(0, 5, n_sub * st) / 4], 1)
    half = slice(2 * st + st // 2, 3 * st)
    r[half, 0] = 6 + rng.integers(0, 4, st - st // 2) / 4
    r[2 * st:2 * st + 9] = [(7.0, y / 4, z / 4) for y in (1, 2, 3) for z in (1, 2, 3)]
    r[6 * st:6 * st + st // 2] = r[2 * st:2 * st + st // 2]
    r[4 * st + 9] = r[4 * st + 2]
    q = np.concatenate([
        np.stack([np.full(qt, 7.25), rng.integers(1, 4, qt) / 4,
                  rng.integers(1, 4, qt) / 4], 1),
        np.stack([6 + rng.integers(0, 5, qt) / 4, rng.integers(0, 5, qt) / 4,
                  rng.integers(0, 5, qt) / 4], 1),
        rng.integers(0, 4 * 3 * n_sub, ((nq_tiles - 2) * qt, 3)) / 4,
    ])
    q[:40, 1:] = 0.25
    rt_ = torch.from_numpy(r.astype(np.float32))
    q4 = torch.cat([torch.from_numpy(q.astype(np.float32)), torch.ones(q.shape[0], 1)], 1)
    r4 = torch.cat([rt_, (-0.5 * (rt_ * rt_).sum(1))[:, None]], 1)
    return q4, r4
