"""Parity of the port's voxel hash (``ops/voxel_knn.py``) with
``e2eslam_tpu/ops/voxel_knn.py``.

The index is integer bookkeeping: its arrays must be equal. The search
takes, per query, the nearest of at most 27 x ``max_per_voxel`` candidates
by float32 distance: found flags and indices must be equal, distances equal
to 1e-6 relative (one rounding of a three-term sum). The clouds include
negative and far coordinates, where the JAX package's int32 products wrap,
and coordinates whose voxel index saturates int32.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2eslam_tpu.ops import voxel_knn as jvox
from e2eslam_tpu_torch.ops import voxel_knn as vox


def _cloud(kind, rng):
    if kind == "scene":  # a box scene's walls, 4 x 3 x 5 m, 5 mm noise
        n = 20000
        p = rng.uniform(0, 1, (n, 3)) * [4, 3, 5]
        axis = rng.integers(0, 3, n)
        p[np.arange(n), axis] = rng.integers(0, 2, n) * np.array([4, 3, 5])[axis]
        p += rng.normal(scale=0.005, size=p.shape)
        q = p[rng.choice(n, 3000)] + rng.normal(scale=0.03, size=(3000, 3))
        return p, q, 0.1, 1 << 16, 16
    if kind == "far":  # negative and far coordinates (the int32 product wraps)
        p = rng.uniform(-400, 400, (6000, 3))
        p[:3000] = p[3000:] + rng.normal(scale=0.2, size=(3000, 3))
        # Voxel coordinates past int32's range: the conversion saturates.
        p[:40] = rng.choice([-1.0, 1.0], (40, 3)) * 3e9
        q = p[rng.choice(6000, 2000)] + rng.normal(scale=0.3, size=(2000, 3))
        q[:20] = p[:20]
        return p, q, 0.5, 1 << 12, 8
    # "dense": a 5 mm grid, so buckets are truncated at max_per_voxel
    xs, ys = np.meshgrid(np.linspace(-1, 1, 300), np.linspace(-1, 1, 300))
    p = np.stack([xs, ys, 0.01 * np.sin(5 * xs)], -1).reshape(-1, 3)
    q = np.concatenate([rng.uniform(-1, 1, (2000, 2)), rng.uniform(-0.05, 0.05, (2000, 1))], 1)
    return p, q, 0.05, 1 << 14, 16


@pytest.mark.parametrize("kind", ["scene", "far", "dense"])
def test_voxel_index_and_search_match_jax(kind):
    rng = np.random.default_rng(0)
    p, q, vs, table, per = _cloud(kind, rng)
    p, q = p.astype(np.float32), q.astype(np.float32)
    count = p.shape[0] - 100  # the last rows are past the count
    got = vox.build_voxel_index(torch.from_numpy(p), count, vs, table_size=table)
    want = jvox.build_voxel_index(jnp.asarray(p), count, vs, table_size=table)
    for name in ("sorted_to_orig", "bucket_start", "sorted_points"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    d, i, f = vox.voxel_knn(torch.from_numpy(q), got, max_per_voxel=per)
    jd, ji, jf = jvox.voxel_knn(jnp.asarray(q), want, max_per_voxel=per)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=0)
    assert f.float().mean() > 0.5 and (i[f] < count).all()


def test_hash_of_wrapping_coordinates_matches_int32():
    """The int64 product masked to the table equals the wrapped int32
    product's bits, at coordinates far past the wrap."""
    rng = np.random.default_rng(1)
    c = rng.integers(-(2**31), 2**31 - 1, size=(5000, 3), dtype=np.int64)
    table = 1 << 20
    got = vox._hash_coords(*(torch.from_numpy(c[:, k]) for k in range(3)), table)
    want = jvox._hash_coords(*(jnp.asarray(c[:, k].astype(np.int32)) for k in range(3)), table)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
