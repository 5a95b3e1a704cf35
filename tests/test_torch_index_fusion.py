"""Parity of the port's index-image fusion and association
(``e2eslam_tpu_torch/slam/fusion.py``) with ``e2eslam_tpu/slam/fusion.py``.

Inputs: the synthetic scene at 64x64, depths with 0.5% Gaussian noise from
a seeded numpy generator (so merges and appends both happen). The JAX
functions run jitted, as its runner runs them.

Tolerances:
  * map rows to 1e-5 (float32 blends; the two compilers order a few
    operations differently);
  * index images, counts and level-2 state equal, except at pixels whose
    candidate's distance lies within 1e-6 of ``dist_th`` (a float32 tie of
    the gate, which the two packages may break differently): at most 4
    such pixels a frame, and the count may differ by as many;
  * ``index_nn``: indices and found flags equal;
  * the duplicate-slot frame: rows to 1e-6, far below the gap between two
    pixels' blends (centimetres), so the last-writer rule is pinned.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2eslam_tpu.data.synthetic import SyntheticDataset
from e2eslam_tpu.slam.fusion import index_nn as jax_index_nn
from e2eslam_tpu.slam.fusion import pointfusion_step_index as jax_fuse_index
from e2eslam_tpu.slam.pointclouds import MapState as JaxMap
from e2eslam_tpu.slam.pointclouds import empty_map as jax_empty
from e2eslam_tpu.slam.rgbd import build_frame as jax_frame
from e2eslam_tpu_torch.slam.fusion import (
    _index_candidates,
    _pixel_alpha,
    frame_pointcloud,
    index_nn,
    pointfusion_step_index,
)
from e2eslam_tpu_torch.slam.pointclouds import empty_map, map_from_arrays
from e2eslam_tpu_torch.slam.rgbd import build_frame
from e2eslam_tpu_torch.slam.slam import PointFusion

H = W = 64
DIST_TH = 0.05
FRAMES = 4


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def seq():
    ds = SyntheticDataset(seqlen=FRAMES + 1, height=H, width=W, dilation=2, total_frames=30)
    colors, depths, K, poses, _ = ds[0]
    rng = np.random.default_rng(0)
    noisy = (depths * (1 + 0.005 * rng.normal(size=depths.shape))).astype(np.float32)
    return (colors / 255.0).astype(np.float32), noisy, K, poses


def _frames(seq, i):
    colors, depths, K, poses = seq
    return (build_frame(_t(colors[i]), _t(depths[i]), _t(K), _t(poses[i])),
            jax_frame(*(jnp.asarray(x) for x in (colors[i], depths[i], K, poses[i]))))


def _jax_fuse(**kw):
    return jax.jit(functools.partial(jax_fuse_index, dist_th=DIST_TH, **kw))


def _near_gate(m, frame, radius):
    """Pixels whose candidate's distance lies within 1e-6 of the gate."""
    live = frame_pointcloud(frame)
    cand, has = _index_candidates(m, frame, live, radius)
    p = m.data.index_select(0, cand.clamp(0, m.data.shape[0] - 1))[:, :3]
    d = torch.linalg.norm(live.points - p, dim=-1)
    return (has & ((d - DIST_TH).abs() < 1e-6)).numpy()


def _check_images(got, want, near):
    """Equal, except at near-gate pixels (at most 4). Returns the count of
    pixels that differ."""
    diff = got.numpy() != np.asarray(want)
    assert not (diff & ~near).any()
    assert diff.sum() <= 4
    return int(diff.sum())


@pytest.mark.parametrize("levels,period,radius", [
    (1, 1, 0), (1, 1, 1), (2, 1, 0), (2, 1, 1), (2, 3, 0), (2, 3, 1)])
def test_index_fusion_matches_jax(seq, levels, period, radius):
    cap = (FRAMES + 1) * H * W
    m = empty_map(cap, index_hw=H * W, index_levels=levels)
    jm = jax_empty(cap, index_hw=H * W, index_levels=levels)
    fuse = _jax_fuse(level2_period=period, search_radius=radius)
    merged = 0
    for i in range(FRAMES):
        f, jf = _frames(seq, i)
        near = _near_gate(m, f, radius)
        before = m.count
        m = pointfusion_step_index(m, f, dist_th=DIST_TH, level2_period=period,
                                   search_radius=radius)
        jm = fuse(jm, jf)
        ties = _check_images(m.index_image, jm.index_image, near)
        assert abs(m.count - int(jm.count)) <= ties, i
        n = min(m.count, int(jm.count))
        if not ties:
            np.testing.assert_allclose(m.data[:n].numpy(), np.asarray(jm.data)[:n],
                                       rtol=1e-5, atol=1e-5, err_msg=f"frame {i}")
        np.testing.assert_array_equal(m.index_pose.numpy(), np.asarray(jm.index_pose))
        if levels == 2:
            assert m.kf_counter == int(jm.kf_counter) == i + 1
            _check_images(m.index_image2, jm.index_image2, near)
            np.testing.assert_array_equal(m.index_pose2.numpy(), np.asarray(jm.index_pose2))
        else:
            assert m.index_image2 is None and m.kf_counter is None
        merged += H * W - (m.count - before)
    assert merged > 0 and m.count > H * W  # both merges and appends happened


@pytest.mark.parametrize("levels", [None, 1, 2])
def test_index_nn_matches_jax(seq, levels):
    """The 3D loss's association on a two-level map fused by the JAX
    package and carried over with ``map_from_arrays``."""
    cap = (FRAMES + 1) * H * W
    jm = jax_empty(cap, index_hw=H * W, index_levels=2)
    fuse = _jax_fuse(level2_period=1)
    for i in range(FRAMES):
        jm = fuse(jm, _frames(seq, i)[1])
    m = map_from_arrays({k: None if v is None else np.asarray(v)
                         for k, v in jm._asdict().items()})
    assert m.count == int(jm.count) and m.kf_counter == FRAMES
    f, jf = _frames(seq, FRAMES)
    idx, found = index_nn(m, f, levels=levels)
    jidx, jfound = jax_index_nn(jm, jf, levels=levels)
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert 0 < int(found.sum()) < H * W


def test_duplicate_slots_resolve_like_jax():
    """A plane at 2 m whose pixels all index 64 map slots (8x8 blocks):
    up to 64 similar pixels blend into each slot. The port's rows equal
    the JAX package's (highest pixel index wins the row)."""
    rng = np.random.default_rng(3)
    K = np.array([[50.0, 0, 32, 0], [0, 50.0, 32, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    color = rng.random((H, W, 3)).astype(np.float32)
    depth = np.full((H, W, 1), 2.0, np.float32)
    pose = np.eye(4, dtype=np.float32)
    f = build_frame(_t(color), _t(depth), _t(K), _t(pose))
    live = frame_pointcloud(f)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    slot = ((ys // 8) * (W // 8) + xs // 8).reshape(-1).astype(np.int32)
    centre = ((np.arange(64) // 8) * 8 + 4) * W + (np.arange(64) % 8) * 8 + 4
    n_map = 64
    data = np.zeros((n_map + H * W, 16), np.float32)
    data[:n_map, 0:3] = live.points.numpy()[centre] + 0.01 * rng.normal(size=(n_map, 3))
    data[:n_map, 3:6] = live.normals.numpy()[centre]
    data[:n_map, 6:9] = rng.random((n_map, 3))
    data[:n_map, 9] = rng.uniform(0.5, 3.0, n_map)
    fields = dict(data=data, count=np.int32(n_map), index_image=slot, index_pose=pose)
    m = map_from_arrays(fields)
    jm = JaxMap(**{k: jnp.asarray(v) for k, v in fields.items()})
    m = PointFusion(fusion_impl="index", dist_th=1.0).step(m, f)[0]
    jm = jax.jit(functools.partial(jax_fuse_index, dist_th=1.0))(
        jm, jax_frame(*(jnp.asarray(x) for x in (color, depth, K, pose))))
    assert m.count == int(jm.count)
    got, want = m.data[:n_map].numpy(), np.asarray(jm.data)[:n_map]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(m.index_image.numpy(), np.asarray(jm.index_image))
    index = m.index_image.numpy()
    merged = index < n_map
    assert np.bincount(index[merged], minlength=n_map).min() >= 30  # many pixels a slot
    # Another rule picks other rows: the lowest merged pixel of each slot
    # would have written points centimetres away.
    alpha = (_pixel_alpha(H, W, _t(K), 0.6) * live.mask).numpy()
    pix = np.arange(H * W)[merged]
    first = {}
    for p in pix[::-1]:
        first[index[p]] = p
    s = np.array(sorted(first))
    lo = np.array([first[k] for k in s])
    c, a = data[s, 9:10], alpha[lo][:, None]
    lowest = (c * data[s, 0:3] + a * live.points.numpy()[lo]) / (c + a)
    assert np.abs(lowest - want[s, 0:3]).max() > 1e-2
