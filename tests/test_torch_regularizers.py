"""Parity of the port's regularizers, point-loss helpers, depth/camera
helpers and ``regather_sorted`` with the JAX package, on seeded numpy
inputs.

Tolerances: the regularizers are float32 means of a few thousand terms,
held to 1e-6 relative (1e-7 absolute for values near zero); the texture
gate is ``exp(-k * band)`` with k = 120 at 64 pixels, where a band value
differing by one float32 rounding of ~1e-8 moves the gate by ~1e-6: held
to 2e-6 absolute. The chamfer and colour losses run the exact KNN on both
sides: 1e-5 relative.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2eslam_tpu.core import camera as jcam
from e2eslam_tpu.core import depth as jdepth
from e2eslam_tpu.core import projection as jproj
from e2eslam_tpu.losses import points as jpoints
from e2eslam_tpu.losses import regularizers as jreg
from e2eslam_tpu.ops import spatial_sort as jsort
from e2eslam_tpu_torch.core import camera, depth, projection
from e2eslam_tpu_torch.losses import points, regularizers
from e2eslam_tpu_torch.ops import spatial_sort

REG = dict(rtol=1e-6, atol=1e-7)


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def test_disparity_smoothness_loss():
    rng = np.random.default_rng(0)
    disp = rng.uniform(0.1, 2.0, (2, 24, 32, 1)).astype(np.float32)
    img = rng.uniform(size=(2, 24, 32, 3)).astype(np.float32)
    want = jreg.disparity_smoothness_loss(_j(disp), _j(img))
    got = regularizers.disparity_smoothness_loss(_t(disp), _t(img))
    np.testing.assert_allclose(float(got), float(want), **REG)


@pytest.mark.parametrize("valid_share", [0.9, 0.3])
def test_geometric_consistency_loss_and_its_guard(valid_share):
    """Above 10000 valid pixels the masked mean, at or below it zero."""
    rng = np.random.default_rng(1)
    shape = (1, 128, 112, 1)  # 14,336 pixels
    dw = rng.uniform(0.5, 4.0, shape).astype(np.float32)
    di = (dw * rng.uniform(0.7, 1.4, shape)).astype(np.float32)
    mask = (rng.random(shape) < valid_share).astype(np.float32)
    want = float(jreg.geometric_consistency_loss(_j(dw), _j(di), _j(mask)))
    got = float(regularizers.geometric_consistency_loss(_t(dw), _t(di), _t(mask)))
    np.testing.assert_allclose(got, want, **REG)
    assert (got == 0.0) == (mask.sum() <= 10000)


@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_depth_regularizer(norm):
    rng = np.random.default_rng(2)
    a = rng.uniform(0.5, 4.0, (2, 16, 20, 1)).astype(np.float32)
    b = (a + rng.normal(size=a.shape) * 0.1).astype(np.float32)
    want = jreg.depth_regularizer(_j(a), _j(b), norm)
    got = regularizers.depth_regularizer(_t(a), _t(b), norm)
    np.testing.assert_allclose(float(got), float(want), **REG)
    with pytest.raises(ValueError):
        regularizers.depth_regularizer(_t(a), _t(b), "l3")


def test_depth_gt_loss_on_a_jax_drawn_mask():
    """The sampler's draws differ between the two packages, so the loss is
    held on the JAX package's own sample, passed to both."""
    rng = np.random.default_rng(3)
    gt = rng.uniform(0.5, 4.0, (32, 40, 1)).astype(np.float32)
    gt[:4] = 0.0
    pred = (gt + rng.normal(size=gt.shape) * 0.2).astype(np.float32)
    sparse, mask = jreg.sparse_sampling(jax.random.key(7), _j(gt), 0.05)
    want = jreg.depth_gt_loss(_j(pred), sparse, mask)
    got = regularizers.depth_gt_loss(_t(pred), _t(sparse), _t(mask))
    np.testing.assert_allclose(float(got), float(want), **REG)


def test_sparse_sampling_statistics():
    """The sampled share of the pixels with depth lies within 4 sigma of
    ``sampling_prob``; a pixel of zero depth is never sampled; the same
    generator seed draws the same mask."""
    rng = np.random.default_rng(4)
    gt = rng.uniform(0.5, 4.0, (256, 320, 1)).astype(np.float32)
    gt[rng.random(gt.shape) < 0.2] = 0.0
    prob = 0.012
    sparse, mask = regularizers.sparse_sampling(torch.Generator().manual_seed(0), _t(gt), prob)
    n = int((gt != 0).sum())
    share = float(mask.sum()) / n
    assert abs(share - prob) < 4.0 * (prob * (1 - prob) / n) ** 0.5
    assert float(mask[_t(gt) == 0].sum()) == 0.0
    assert torch.equal(sparse, _t(gt) * mask)
    _, again = regularizers.sparse_sampling(torch.Generator().manual_seed(0), _t(gt), prob)
    assert torch.equal(mask, again)
    with pytest.raises(ValueError):
        regularizers.sparse_sampling(torch.Generator(), _t(gt), prob, "grid")


@pytest.mark.parametrize("k", [600.0, 150.0])
def test_texture_gate(k):
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(64, 64, 3)).astype(np.float32)
    img[:, 32:] = 0.5  # a flat half: the gate is 1 there
    img[:, 32:] += rng.normal(size=(64, 32, 3)).astype(np.float32) * 0.01
    want = np.asarray(jpoints.texture_gate(_j(img), k))
    got = points.texture_gate(_t(img), k).numpy()
    assert got.shape == (64 * 64,)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert got.min() < 0.9 and got.max() > 0.99  # textured vs flat half


def _clouds(seed, na=700, nb=900):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(na, 3)).astype(np.float32)
    b = (a[rng.integers(0, na, nb)] + rng.normal(size=(nb, 3)) * 0.05).astype(np.float32)
    return a, b


def test_color_points_loss():
    a, b = _clouds(6)
    rng = np.random.default_rng(6)
    ca = rng.uniform(size=a.shape).astype(np.float32)
    cb = rng.uniform(size=b.shape).astype(np.float32)
    _, idx = points.knn_points_loss(_t(a), _t(b))
    want = jpoints.color_points_loss(_j(ca), _j(cb), _j(idx.numpy()), n_query=800)
    got = points.color_points_loss(_t(ca), _t(cb), idx, n_query=800)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_chamfer_distance(bidirectional):
    a, b = _clouds(7)
    ta, tb = _t(a).requires_grad_(True), _t(b)
    got = points.chamfer_distance(ta, tb, n_a=650, n_b=850, bidirectional=bidirectional)
    want, grad = jax.value_and_grad(
        lambda x: jpoints.chamfer_distance(x, _j(b), n_a=650, n_b=850,
                                           bidirectional=bidirectional))(_j(a))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    got.backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(grad), rtol=1e-5, atol=1e-7)


def test_regather_sorted_matches_jax():
    """A stale permutation over a map that grew since the sort: the same
    view, and the valid rows still form its prefix."""
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(4096, 3)).astype(np.float32)
    c0, c1 = 1500, 2300
    jm = jsort.sort_map_points(_j(pts), c0)
    tm = spatial_sort.sort_map_points(_t(pts), c0)
    np.testing.assert_array_equal(tm.perm.numpy(), np.asarray(jm.perm))
    grown = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.01  # rows moved by fusion
    want = jsort.regather_sorted(_j(grown), jm.perm, jm.inv_perm)
    got = spatial_sort.regather_sorted(_t(grown), tm.perm, tm.inv_perm)
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    np.testing.assert_array_equal(got.inv_perm.numpy(), np.asarray(want.inv_perm))
    assert set(got.perm[:c1].tolist()) == set(range(c1))


def test_disp_to_depth_and_scale_disp():
    d = np.random.default_rng(9).uniform(0.01, 0.99, (2, 8, 8, 1)).astype(np.float32)
    for fn in ("scale_disp", "disp_to_depth"):
        np.testing.assert_allclose(getattr(depth, fn)(_t(d), 0.1, 80.0).numpy(),
                                   np.asarray(getattr(jdepth, fn)(_j(d), 0.1, 80.0)),
                                   rtol=1e-6)


def test_normalize_intrinsics():
    K = np.array([[280.0, 0, 160, 0], [0, 285, 128, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                 np.float32)
    np.testing.assert_array_equal(camera.normalize_intrinsics(_t(K)).numpy(),
                                  np.asarray(jcam.normalize_intrinsics(_j(K))))


def test_project_returns_the_clamped_warped_depth():
    rng = np.random.default_rng(10)
    H, W = 12, 16
    pts = np.concatenate([rng.uniform(-1, 1, (1, H, W, 2)),
                          rng.uniform(-0.5, 4.0, (1, H, W, 1))], -1).astype(np.float32)
    K = np.array([[[12.0, 0, 8, 0], [0, 12, 6, 0], [0, 0, 1, 0], [0, 0, 0, 1]]], np.float32)
    T = np.eye(4, dtype=np.float32)[None].copy()
    T[0, :3, 3] = [0.1, -0.05, 0.2]
    want = jproj.project(_j(pts), _j(K), _j(T), return_depth=True)
    got = projection.project(_t(pts), _t(K), _t(T), return_depth=True)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    assert float(got[1].min()) == float(np.float32(projection.MIN_WARPED_DEPTH))
