"""Parity of the port's SLAM layer (frames, the packed map, scatter
PointFusion with its active window, projective association, the front
ends with gt, gradICP and ICP odometry) with ``e2eslam_tpu/slam``.

Tolerances: frame geometry in float32, 1e-5 relative / 1e-5 absolute.
Fusion is a chain of threshold decisions (distance gate, normal gate,
closest-then-lowest-index winner); on these inputs every decision falls
the same way, so counts are equal and the fused rows agree to 1e-5.
Estimated poses agree to 1e-5 (tests/test_torch_odometry.py holds the
odometry itself to 1e-4); geometry placed by an estimated pose, to 1e-4
absolute (the pose's gap times the scene's 5 m extent).

The JAX ``ICPSLAM.step`` raises (its map update lacks ``row_ops``,
``e2eslam_tpu/slam/slam.py:133``, ``:193``), so the port's ICPSLAM is held
against the JAX ``_append_frame`` and ``gradicp`` composed by hand.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)
from torch_omp import pinned_threads

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
from e2eslam_tpu_torch.slam.fusion import _pixel_alpha, pointfusion_step, projective_nn
from e2eslam_tpu_torch.slam.pointclouds import MapState, empty_map, pack_rows
from e2eslam_tpu_torch.slam.rgbd import build_frame, normal_map
from e2eslam_tpu_torch.slam.slam import ICPSLAM, PointFusion

H, W = 48, 64
TOL = dict(rtol=1e-5, atol=1e-5)
EST_TOL = dict(rtol=0, atol=1e-4)


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


def _frames(seq, i, depths=None):
    colors, d, K, poses = seq
    d = d if depths is None else depths
    return (build_frame(_t(colors[i]), _t(d[i]), _t(K), _t(poses[i])),
            jax_frame(*(jnp.asarray(x) for x in (colors[i], d[i], K, poses[i]))))


def _same_map(m, jm, tol=TOL):
    assert m.count == int(jm.count)
    np.testing.assert_allclose(m.data[: m.count].numpy(), np.asarray(jm.data)[: m.count], **tol)


def test_slam_step_gt_odometry(seq):
    slam, jslam = PointFusion(odom="gt"), JaxPointFusion(odom="gt")
    prev, jprev = _frames(seq, 0)
    live, jlive = _frames(seq, 1)
    m = slam._update_map(empty_map(2 * H * W), prev)
    jm = jslam._update_map(jax_empty(2 * H * W), jprev)
    m, pose, fused = slam.step(m, live, prev)
    jm, jpose, _ = jslam.step(jm, jlive, jprev)
    np.testing.assert_array_equal(pose.numpy(), np.asarray(jpose))
    assert fused is live  # gt odometry fuses the frame as given
    _same_map(m, jm)
    with pytest.raises(ValueError):
        PointFusion(odom="orb")


@pytest.mark.parametrize("odom", ["gradicp", "icp"])
def test_slam_step_estimated_odometry(seq, odom):
    """One step: the pose, the frame rebuilt at it, the fused map. The ICP's
    reductions split by torch's thread count, and one pixel of the fused map
    sits on a projection edge: with 4 threads the gradICP step's map holds
    one row more than the JAX package's, so the count is pinned to 8."""
    slam = PointFusion(odom=odom, icp_downsample=2)
    jslam = JaxPointFusion(odom=odom, icp_downsample=2)
    prev, jprev = _frames(seq, 0)
    live, jlive = _frames(seq, 2)
    m = slam._update_map(empty_map(2 * H * W), prev)
    jm = jslam._update_map(jax_empty(2 * H * W), jprev)
    with pinned_threads(8):
        m, pose, fused = slam.step(m, live, prev)
    jm, jpose, jfused = jslam.step(jm, jlive, jprev)
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), atol=1e-5, rtol=0)
    assert np.abs(pose.numpy() - seq[3][2]).max() > 1e-5  # estimated, not the dataset's
    np.testing.assert_array_equal(fused.pose.numpy(), pose.numpy())
    np.testing.assert_allclose(fused.vertices.numpy(), np.asarray(jfused.vertices), **EST_TOL)
    _same_map(m, jm, EST_TOL)


@pytest.mark.parametrize("case", ["gt", "gradicp", "gradicp detach_poses"])
def test_whole_sequence_call_matches_jax(seq, case):
    """``PointFusion.__call__`` over the sequence's frames against the JAX
    ``lax.scan``: poses and map."""
    colors, depths, K, poses = seq
    odom = case.split()[0]
    detach = "detach" in case
    slam = PointFusion(odom=odom, icp_downsample=2)
    jslam = JaxPointFusion(odom=odom, icp_downsample=2)
    m, est = slam(_t(colors), _t(depths), _t(K), _t(poses), capacity=3 * H * W,
                  detach_poses=detach)
    jm, jest = jslam(*(jnp.asarray(x) for x in (colors, depths, K, poses)),
                     capacity=3 * H * W, detach_poses=detach)
    assert est.shape == (3, 4, 4)
    np.testing.assert_allclose(est.numpy(), np.asarray(jest), atol=1e-5, rtol=0)
    _same_map(m, jm, EST_TOL)


def test_icpslam_matches_append_and_gradicp(seq):
    """ICPSLAM's steps against the JAX ``_append_frame`` with the frame
    rebuilt at the JAX ``gradicp`` pose: every valid pixel appended."""
    from e2eslam_tpu.slam.odometry import gradicp as jax_gradicp
    from e2eslam_tpu.slam.slam import _append_frame as jax_append

    slam = ICPSLAM(icp_downsample=2)
    m = slam._update_map(empty_map(3 * H * W), _frames(seq, 0)[0])
    jm = jax_append(jax_empty(3 * H * W), _frames(seq, 0)[1])
    prev, jprev = _frames(seq, 0)
    for i in (1, 2):
        live, jlive = _frames(seq, i)
        m, pose, prev = slam.step(m, live, prev)
        jpose = jax_gradicp(jlive, jprev, numiters=20, dist_th=0.2, downsample=2)
        jprev = jax_frame(jlive.color, jlive.depth, jlive.intrinsics, jpose)
        jm = jax_append(jm, jprev)
        np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), atol=1e-5, rtol=0)
    _same_map(m, jm, EST_TOL)
    assert m.count == int((seq[1] > 0).sum())


def test_active_window_large_equals_full(seq):
    (f, jf), (g, jg) = _frames(seq, 0), _frames(seq, 1)
    full = pointfusion_step(pointfusion_step(empty_map(2 * H * W), f), g)
    aw = 2 * H * W + 5
    win = pointfusion_step(pointfusion_step(empty_map(2 * H * W), f, active_window=aw), g,
                           active_window=aw)
    assert full.count == win.count
    assert torch.equal(full.data, win.data)


@pytest.mark.parametrize("window", [512, 3000])
def test_active_window_matches_jax(seq, window):
    """A window smaller than the map: association and fusion among the
    newest rows, appends into the full buffer (the map still grows)."""
    colors, depths, K, poses = seq
    rng = np.random.default_rng(1)
    noisy = (depths * (1 + 0.01 * rng.normal(size=depths.shape))).astype(np.float32)
    m, jm = empty_map(3 * H * W), jax_empty(3 * H * W)
    counts = []
    for i in range(3):
        f, jf = _frames(seq, i, noisy)
        m = pointfusion_step(m, f, active_window=window)
        jm = jax_fuse(jm, jf, active_window=window)
        _same_map(m, jm)
        counts.append(m.count)
    assert counts[0] == int((noisy[0] > 0).sum()) and counts[0] < counts[1] < counts[2]
    assert np.isfinite(m.data[: m.count].numpy()).all()


def test_projective_nn_matches_jax_and_window_indices_are_global(seq):
    from e2eslam_tpu.slam.fusion import projective_nn as jax_projective_nn

    (f, jf), (g, jg) = _frames(seq, 0), _frames(seq, 1)
    m = pointfusion_step(empty_map(2 * H * W), f)
    jm = jax_fuse(jax_empty(2 * H * W), jf)
    for window in (None, 1024):
        idx, found = projective_nn(m, g, active_window=window)
        jidx, jfound = jax_projective_nn(jm, jg, active_window=window)
        np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert found.any() and int(idx[found].max()) < m.count
    # The window's candidates are the newest rows.
    assert int(idx[found].min()) >= m.count - 1024


def test_map_state_views():
    m = MapState(data=torch.arange(32.0).reshape(2, 16), count=1)
    assert m.points.shape == (2, 3) and m.confidence.tolist() == [9.0, 25.0]


def _key_winners(pix, dist, similar, HW):
    """Each pixel's winning row by the CUDA fusion kernel's rule: one min
    over ``(float bits of dist << 32) | row`` (``ops/csrc/pointfusion.cu``;
    the kernel's unsigned all-ones "none" is int64's largest value here)."""
    rows = torch.arange(pix.shape[0], dtype=torch.int64)
    key = (dist.view(torch.int32).to(torch.int64) << 32) | rows
    empty = torch.iinfo(torch.int64).max
    key = torch.where(similar, key, torch.full_like(key, empty))
    best = torch.full((HW,), empty, dtype=torch.int64).scatter_reduce(0, pix, key, "amin")
    return torch.where(best == empty, torch.full_like(best, pix.shape[0]),
                       best & 0xFFFFFFFF)


def _key_case(case, rng):
    """(pix, dist, similar, HW) of a ranking case: many rows on few pixels."""
    n, HW, count = 4000, 64, 3000
    pix = torch.from_numpy(rng.integers(0, HW, n))
    # Few distinct values, so equal distances share pixels.
    dist = torch.from_numpy(rng.choice(np.float32([0.0, 0.01, 0.02, 0.02001, 0.04]), n))
    similar = torch.from_numpy(rng.random(n) < 0.7)
    if case == "inf":
        dist = torch.where(torch.from_numpy(rng.random(n) < 0.5), float("inf"), dist)
    elif case == "subnormal":
        tiny = np.float32([1e-45, 2e-45, 1e-40, 1.1754942e-38, 1.17549435e-38])
        dist = torch.from_numpy(rng.choice(tiny, n))
        assert bool((dist < 1.17549435e-38).any())  # subnormals among them
    elif case == "past_count":
        # The buffer's rows past the count are zeros: distance 0, all on one
        # clamped pixel, never similar.
        rows = torch.arange(n)
        pix = torch.where(rows < count, pix, 0)
        dist = torch.where(rows < count, dist, 0.0)
        similar = similar & (rows < count)
    return pix, dist.float(), similar, HW


@pytest.mark.parametrize("case", ["ties", "inf", "subnormal", "past_count"])
def test_fusion_kernel_key_picks_the_plain_winners(case):
    """The CUDA fusion kernel ranks a pixel's similar rows with a single
    64-bit min over (distance bits, row): for non-negative floats the bit
    order is the value order, so it picks ``_rank``'s winner (the closest
    row, then the lowest), whatever the order of the atomics."""
    from e2eslam_tpu_torch.slam.fusion import _rank

    pix, dist, similar, HW = _key_case(case, np.random.default_rng(5))
    best_idx, winner = _rank(pix, dist, similar, HW)
    np.testing.assert_array_equal(_key_winners(pix, dist, similar, HW).numpy(),
                                  best_idx.numpy())
    assert int(winner.sum()) == int((best_idx < pix.shape[0]).sum()) > 0
    # Ties were there to break: a pixel whose closest distance two similar
    # rows share.
    best_d = torch.where(best_idx < pix.shape[0], dist[best_idx.clamp(max=pix.shape[0] - 1)],
                         float("nan"))
    tied = similar & (dist == best_d[pix])
    assert int(torch.bincount(pix[tied], minlength=HW).max()) > 1
