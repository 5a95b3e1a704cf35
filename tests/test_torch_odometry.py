"""Parity of the port's ICP odometry with ``e2eslam_tpu/slam/odometry.py``
and of the engine's estimated-pose view synthesis transform
(``RefinementEngine._source_transform``) with the JAX engine's.

Frames: the synthetic scene at 64x64, consecutive frames 0.08 m
apart. Tolerances: poses to 1e-4 absolute (each iteration's association is
a chain of threshold decisions, rounded pixel coordinates and a distance
gate, that fall the same way on both sides here; what is left is float32
rounding through up to 20 solves; the gaps seen are below 2e-7). The depth
gradient of the estimated transform to 5e-4 of its largest entry (4.6e-5
seen): the backward runs through 20 Cholesky solves and sigmoid gates in
each package's own float32 order.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2eslam_tpu.config import default_config_path as jax_default_path
from e2eslam_tpu.config import load_yaml as jax_load_yaml
from e2eslam_tpu.data.synthetic import SyntheticDataset
from e2eslam_tpu.engine.refine import PairBatch as JaxPair
from e2eslam_tpu.engine.refine import RefinementEngine as JaxEngine
from e2eslam_tpu.slam import odometry as jodo
from e2eslam_tpu.slam.rgbd import build_frame as jax_frame
from e2eslam_tpu.slam.slam import PointFusion as JaxPointFusion
from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.core.camera import inverse_intrinsics
from e2eslam_tpu_torch.core.projection import backproject
from e2eslam_tpu_torch.engine.refine import PairBatch, RefinementEngine
from e2eslam_tpu_torch.slam import odometry
from e2eslam_tpu_torch.slam.rgbd import build_frame, normal_map
from e2eslam_tpu_torch.slam.slam import PointFusion

H = W = 64


@pytest.fixture(scope="module")
def seq():
    ds = SyntheticDataset(seqlen=3, height=H, width=W, dilation=1, start=10,
                          total_frames=40)
    colors, depths, K, poses, _ = ds[0]
    return (colors / 255.0).astype(np.float32), depths.astype(np.float32), K, poses


def _t(x):
    return torch.from_numpy(np.array(x))


def _frames(seq, i, j):
    colors, depths, K, poses = seq
    port = [build_frame(_t(colors[k]), _t(depths[k]), _t(K), _t(poses[k])) for k in (i, j)]
    jx = [jax_frame(*(jnp.asarray(x) for x in (colors[k], depths[k], K, poses[k])))
          for k in (i, j)]
    return port, jx


@pytest.mark.parametrize("soft", [True, False], ids=["gradicp", "icp"])
@pytest.mark.parametrize("numiters", [8, 20])
@pytest.mark.parametrize("downsample", [1, 4])
def test_gradicp_matches_jax(seq, soft, numiters, downsample):
    (prev, live), (jprev, jlive) = _frames(seq, 0, 2)
    got = odometry.gradicp(live, prev, numiters=numiters, downsample=downsample, soft=soft)
    want = jodo.gradicp(jlive, jprev, numiters=numiters, downsample=downsample, soft=soft)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    # The odometry moved the pose off the previous frame's.
    assert np.abs(got.numpy() - seq[3][0]).max() > 1e-3


@pytest.mark.parametrize("soft", [True, False], ids=["gradicp", "icp"])
def test_point_to_plane_icp_matches_jax(seq, soft):
    """The solver alone, with an initial transform, on the camera-frame
    vertex and normal maps."""
    (prev, live), _ = _frames(seq, 1, 2)
    K = live.intrinsics
    src = backproject(live.depth[None], inverse_intrinsics(K)[None])[0][::2, ::2].reshape(-1, 3)
    msk = live.valid[::2, ::2].reshape(-1)
    tgt = backproject(prev.depth[None], inverse_intrinsics(K)[None])[0]
    nrm = normal_map(tgt)
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.01, -0.01, 0.02]
    got = odometry.point_to_plane_icp(src, msk, tgt, nrm, prev.valid[..., 0], K, numiters=10,
                                      soft=soft, init_T=_t(init))
    want = jodo.point_to_plane_icp(*(jnp.asarray(x.numpy()) for x in
                                     (src, msk, tgt, nrm, prev.valid[..., 0], K)),
                                   numiters=10, soft=soft, init_T=jnp.asarray(init))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_too_few_correspondences_hold_the_pose(seq):
    """With at most 32 weighted correspondences every iteration holds the
    initial transform, on both sides."""
    (prev, live), _ = _frames(seq, 0, 1)
    K = live.intrinsics
    src = backproject(live.depth[None], inverse_intrinsics(K)[None])[0].reshape(-1, 3)
    msk = torch.zeros(src.shape[0])
    msk[:30] = 1.0  # 30 live points
    tgt = backproject(prev.depth[None], inverse_intrinsics(K)[None])[0]
    args = (src, msk, tgt, normal_map(tgt), prev.valid[..., 0], K)
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.02, 0.0, -0.01]
    for soft in (True, False):
        got = odometry.point_to_plane_icp(*args, numiters=5, soft=soft, init_T=_t(init))
        want = jodo.point_to_plane_icp(*(jnp.asarray(x.numpy()) for x in args), numiters=5,
                                       soft=soft, init_T=jnp.asarray(init))
        np.testing.assert_array_equal(got.numpy(), init)
        np.testing.assert_array_equal(np.asarray(want), init)


def _engines(odom):
    def cfg(load, path):
        c = load(path)
        c.DATA.use_gt_pose = False
        c.MODEL.odom = odom
        return c

    port = SimpleNamespace(config=cfg(load_yaml, default_config_path()), slam=PointFusion())
    jx = SimpleNamespace(config=cfg(jax_load_yaml, jax_default_path()), slam=JaxPointFusion())
    return port, jx


@pytest.mark.parametrize("odom", ["gradicp", "icp"])
def test_source_transform_and_its_depth_gradient_match_jax(seq, odom):
    """The estimated target->source transform of a window and the gradient
    of a weighted sum of its entries with respect to both depths."""
    colors, depths, K, poses = seq
    rng = np.random.default_rng(0)
    depth = (depths[:2] * (1 + 0.01 * rng.normal(size=depths[:2].shape))).astype(np.float32)
    weights = rng.normal(size=(4, 4)).astype(np.float32)
    port, jx = _engines(odom)
    pair = PairBatch(*(_t(x) for x in (colors[:2], depths[:2], K, poses[:2])))
    jpair = JaxPair(*(jnp.asarray(x) for x in (colors[:2], depths[:2], K, poses[:2])))

    d = _t(depth).requires_grad_(True)
    T = RefinementEngine._source_transform(port, pair, d, 0)
    (T * _t(weights)).sum().backward()

    def jf(dd):
        return jnp.sum(JaxEngine._source_transform(jx, jpair, dd, 0) * weights)

    want_T = np.asarray(JaxEngine._source_transform(jx, jpair, jnp.asarray(depth), 0))
    want_g = np.asarray(jax.grad(jf)(jnp.asarray(depth)))
    np.testing.assert_allclose(T.detach().numpy(), want_T, atol=1e-4, rtol=0)
    got_g = d.grad.numpy()
    assert np.isfinite(got_g).all() and np.abs(want_g).max() > 0
    np.testing.assert_allclose(got_g, want_g, atol=5e-4 * np.abs(want_g).max(), rtol=0)
