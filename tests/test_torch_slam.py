"""Parity of the port's SLAM layer (frames, the packed map, scatter
PointFusion) with ``e2eslam_tpu/slam``.

Tolerances: frame geometry in float32, 1e-5 relative / 1e-5 absolute.
Fusion is a chain of threshold decisions (distance gate, normal gate,
closest-then-lowest-index winner); on these inputs every decision falls
the same way, so counts are equal and the fused rows agree to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2eslam_tpu.data.synthetic import SyntheticDataset
from e2eslam_tpu.slam.fusion import pointfusion_step as jax_fuse
from e2eslam_tpu.slam.pointclouds import empty_map as jax_empty
from e2eslam_tpu.slam.rgbd import build_frame as jax_frame
from e2eslam_tpu.slam.rgbd import normal_map as jax_normals
from e2eslam_tpu.slam.slam import PointFusion as JaxPointFusion
from e2eslam_tpu_torch.slam.fusion import _pixel_alpha, pointfusion_step
from e2eslam_tpu_torch.slam.pointclouds import MapState, empty_map, pack_rows
from e2eslam_tpu_torch.slam.rgbd import build_frame, normal_map
from e2eslam_tpu_torch.slam.slam import PointFusion

H, W = 48, 64
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def seq():
    ds = SyntheticDataset(seqlen=3, height=H, width=W, dilation=3, total_frames=30)
    colors, depths, K, poses, _ = ds[0]
    return (colors / 255.0).astype(np.float32), depths, K, poses


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("frame", [0, 2])
def test_normal_map(seq, frame):
    colors, depths, K, poses = seq
    f = jax_frame(jnp.asarray(colors[frame]), jnp.asarray(depths[frame]), jnp.asarray(K))
    v = np.asarray(f.vertices)
    n = normal_map(_t(v))
    np.testing.assert_allclose(n.numpy(), np.asarray(jax_normals(jnp.asarray(v), "zero")),
                               **TOL)
    assert not n[-1].any() and not n[:, -1].any()  # zero border normals


def test_build_frame(seq):
    colors, depths, K, poses = seq
    a = build_frame(_t(colors[1]), _t(depths[1]), _t(K), _t(poses[1]))
    b = jax_frame(jnp.asarray(colors[1]), jnp.asarray(depths[1]), jnp.asarray(K),
                  jnp.asarray(poses[1]))
    for name in ("vertices", "normals", "valid", "depth"):
        np.testing.assert_allclose(getattr(a, name).numpy(), np.asarray(getattr(b, name)),
                                   **TOL, err_msg=name)


def test_pixel_alpha_and_pack_rows(seq):
    from e2eslam_tpu.slam.fusion import _pixel_alpha as jax_alpha
    from e2eslam_tpu.slam.pointclouds import pack_rows as jax_pack

    _, _, K, _ = seq
    np.testing.assert_allclose(_pixel_alpha(H, W, _t(K), 0.6).numpy(),
                               np.asarray(jax_alpha(H, W, jnp.asarray(K), 0.6)), **TOL)
    rng = np.random.default_rng(0)
    p, n, c = rng.normal(size=(3, 10, 3)).astype(np.float32)
    w = rng.random(10).astype(np.float32)
    np.testing.assert_array_equal(
        pack_rows(_t(p), _t(n), _t(c), _t(w)).numpy(),
        np.asarray(jax_pack(jnp.asarray(p), jnp.asarray(n), jnp.asarray(c), jnp.asarray(w))))


def test_pointfusion_over_three_frames(seq):
    """Fuse three frames (with depth noise, so merges and appends both
    happen) on both sides: equal counts, equal rows."""
    colors, depths, K, poses = seq
    rng = np.random.default_rng(1)
    noisy = (depths * (1 + 0.01 * rng.normal(size=depths.shape))).astype(np.float32)
    cap = 3 * H * W
    m = empty_map(cap)
    jm = jax_empty(cap)
    for i in range(3):
        f = build_frame(_t(colors[i]), _t(noisy[i]), _t(K), _t(poses[i]))
        jf = jax_frame(jnp.asarray(colors[i]), jnp.asarray(noisy[i]), jnp.asarray(K),
                       jnp.asarray(poses[i]))
        m = pointfusion_step(m, f)
        jm = jax_fuse(jm, jf)
        assert m.count == int(jm.count), i
        np.testing.assert_allclose(m.data[: m.count].numpy(),
                                   np.asarray(jm.data)[: m.count], **TOL)
    assert H * W < m.count < 3 * H * W  # some merged, some appended


def test_slam_step_gt_odometry(seq):
    colors, depths, K, poses = seq
    slam, jslam = PointFusion(odom="gt"), JaxPointFusion(odom="gt")
    prev = build_frame(_t(colors[0]), _t(depths[0]), _t(K), _t(poses[0]))
    live = build_frame(_t(colors[1]), _t(depths[1]), _t(K), _t(poses[1]))
    jprev = jax_frame(*(jnp.asarray(x) for x in (colors[0], depths[0], K, poses[0])))
    jlive = jax_frame(*(jnp.asarray(x) for x in (colors[1], depths[1], K, poses[1])))
    m = slam._update_map(empty_map(2 * H * W), prev)
    jm = jslam._update_map(jax_empty(2 * H * W), jprev)
    m, pose = slam.step(m, live, prev)
    jm, jpose, _ = jslam.step(jm, jlive, jprev)
    assert m.count == int(jm.count)
    np.testing.assert_array_equal(pose.numpy(), np.asarray(jpose))
    np.testing.assert_allclose(m.data[: m.count].numpy(), np.asarray(jm.data)[: m.count],
                               **TOL)
    with pytest.raises(NotImplementedError):
        PointFusion(odom="gradicp")


def test_map_state_views():
    m = MapState(data=torch.arange(32.0).reshape(2, 16), count=1)
    assert m.points.shape == (2, 3) and m.confidence.tolist() == [9.0, 25.0]
