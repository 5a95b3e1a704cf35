"""The port's map compaction against the JAX package's (slam/compact.py).

Maps are fused by the JAX package from the same synthetic frames as
tests/test_slam.py:452-616 builds them (scatter fusion with a tiny gate, so
re-observations append duplicates; index fusion with two index levels) and
carried over to the port (``map_from_arrays``). Each pass, voxel and
projective, runs on both: the counts are equal, the packed rows agree to
float32 rounding (1e-6; the confidence-weighted sums add the same rows in
the same order on the CPU), the rows past the count are zero, and both
index images are equal element for element. The pass is fixed-shape:
from a device count it reads nothing to the host (``_NoHostRead``), and a
bucket above the count (the host bound the programs take) gives the full
pass's map.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from e2eslam_tpu.data.synthetic import SyntheticDataset
from e2eslam_tpu.slam import compact as jax_compact
from e2eslam_tpu.slam.fusion import pointfusion_step, pointfusion_step_index
from e2eslam_tpu.slam.pointclouds import empty_map as jax_empty
from e2eslam_tpu.slam.pointclouds import pack_rows as jax_pack_rows
from e2eslam_tpu.slam.rgbd import build_frame
from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.engine.refine import RefinementEngine
from e2eslam_tpu_torch.models.depth_net import make_depth_model
from e2eslam_tpu_torch.slam.compact import compact_map, compact_map_projective
from e2eslam_tpu_torch.slam.pointclouds import map_from_arrays, on_device

H, W = 64, 80


@pytest.fixture(scope="module")
def seq():
    ds = SyntheticDataset(seqlen=3, height=H, width=W, dilation=4, total_frames=30)
    colors, depths, K, poses, _ = ds[0]
    frames = [build_frame(jnp.asarray(colors[i] / 255.0), jnp.asarray(depths[i]),
                          jnp.asarray(K), jnp.asarray(poses[i])) for i in range(3)]
    return frames, K, poses


@pytest.fixture(scope="module")
def maps(seq):
    frames, _, _ = seq
    dup = jax_empty(4 * H * W)
    for f in frames:
        dup = pointfusion_step(dup, f, dist_th=1e-6)
    index = jax_empty(4 * H * W, index_hw=H * W, index_levels=2)
    for f in frames:
        index = pointfusion_step_index(index, f)
    return {"scatter": dup, "index": index}


def _port(m):
    return map_from_arrays(jax.tree_util.tree_map(np.asarray, m._asdict()))


def _assert_same(got, want):
    n = int(want.count)
    assert got.count == n
    np.testing.assert_allclose(got.data[:n].numpy(), np.asarray(want.data[:n]), rtol=1e-6,
                               atol=1e-6)
    assert not got.data[n:].any()
    for name in ("index_image", "index_image2"):
        w = getattr(want, name)
        if w is None:
            assert getattr(got, name) is None
        else:
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(w),
                                          err_msg=name)
    assert got.kf_counter == (None if want.kf_counter is None else int(want.kf_counter))


@pytest.mark.parametrize("name", ["scatter", "index"])
@pytest.mark.parametrize("voxel", [0.02, 0.03])
def test_compact_map_matches_jax(maps, name, voxel):
    m = maps[name]
    want = jax_compact.compact_map(m, voxel=voxel)
    got = compact_map(_port(m), voxel=voxel)
    assert 0 < got.count < int(m.count)
    _assert_same(got, want)


@pytest.mark.parametrize("name", ["scatter", "index"])
def test_compact_map_projective_matches_jax(seq, maps, name):
    _, K, poses = seq
    m = maps[name]
    want = jax_compact.compact_map_projective(m, jnp.asarray(poses[2]), jnp.asarray(K),
                                              height=H, width=W, dist_gate=0.05,
                                              normal_gate_deg=20.0)
    got = compact_map_projective(_port(m), torch.from_numpy(poses[2]), torch.from_numpy(K),
                                 height=H, width=W, dist_gate=0.05, normal_gate_deg=20.0)
    assert 0 < got.count < int(m.count)
    _assert_same(got, want)


def _spread_map(pts, nrm):
    """A JAX map and its port copy holding rows of ``pts`` with normals
    ``nrm``, colour 0.5 and confidence 1."""
    n = len(pts)
    m = jax_empty(n + 8)
    rows = jax_pack_rows(jnp.asarray(pts), jnp.asarray(nrm), jnp.full((n, 3), 0.5),
                         jnp.ones((n,)))
    m = m._replace(data=m.data.at[:n].set(rows), count=jnp.asarray(n, jnp.int32))
    return m, _port(m)


def test_hash_collisions_do_not_merge():
    """600 points in distinct voxels, a 256-bucket table: buckets collide,
    nothing merges, the confidence is conserved."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-50.0, 50.0, (600, 3)).astype(np.float32)
    m, pm = _spread_map(pts, np.full((600, 3), 1 / np.sqrt(3.0), np.float32))
    got = compact_map(pm, voxel=0.05, table_pow=8)
    assert got.count == 600
    assert float(got.confidence[:600].sum()) == pytest.approx(600.0, rel=1e-6)
    _assert_same(got, jax_compact.compact_map(m, voxel=0.05, table_pow=8))


def test_projective_gates():
    """tests/test_slam.py's cases: a co-ray pair in one depth bin merges; a
    neighbouring-pixel pair, a pair with opposing normals (the normal gate)
    and out-of-view or behind-the-camera points survive; a 5 cm voxel pass
    merges the neighbouring pair too."""
    pose = np.eye(4, dtype=np.float32)
    K = np.diag([100.0, 100.0, 1.0, 1.0]).astype(np.float32)
    K[0, 2] = K[1, 2] = 32.0
    pts = np.asarray([[0.0, 0.0, 2.0], [0.0, 0.0, 2.02], [0.06, 0.0, 2.0], [0.08, 0.0, 2.0],
                      [0.5, 0.0, 2.0], [0.5, 0.0, 2.01], [10.0, 0.0, 2.0], [10.0, 0.0, 2.005],
                      [0.0, 0.0, -1.0]], np.float32)
    nrm = np.tile(np.asarray([0.0, 0.0, -1.0], np.float32), (len(pts), 1))
    nrm[5] = -nrm[5]
    m, pm = _spread_map(pts, nrm)
    got = compact_map_projective(pm, torch.from_numpy(pose), torch.from_numpy(K), height=64,
                                 width=64, dist_gate=0.05, normal_gate_deg=20.0)
    assert got.count == len(pts) - 1
    out = got.points[: got.count].numpy()
    assert np.linalg.norm(out - [0.0, 0.0, 2.01], axis=-1).min() < 1e-3
    assert np.linalg.norm(out - pts[2], axis=-1).min() < 1e-6
    _assert_same(got, jax_compact.compact_map_projective(
        m, jnp.asarray(pose), jnp.asarray(K), height=64, width=64, dist_gate=0.05,
        normal_gate_deg=20.0))
    assert compact_map(pm, voxel=0.05).count < len(pts) - 1


def _engine(mode):
    cfg = load_yaml(default_config_path())
    cfg.DATA.height, cfg.DATA.width = H, W
    cfg.MODEL.compact_mode = mode
    cfg.MODEL.compact_live_voxel = 0.03
    return RefinementEngine(cfg, make_depth_model(cfg), map_capacity=4 * H * W,
                            device=torch.device("cpu"))


def _copy(m, device_count=False):
    m = dataclasses.replace(m, data=m.data.clone())
    return on_device(m) if device_count else m


@pytest.mark.parametrize("device_count", [False, True])
@pytest.mark.parametrize("mode", ["voxel", "projective"])
def test_bucketed_compact_now_equals_full_pass(seq, maps, mode, device_count):
    """``compact_now`` over ``data[:bucket]``, written back into the full
    buffer, equals the pass over the whole buffer (rows, count, both index
    images) for any bucket that holds the count: just above it, and the
    buffer's last rows (a host bound far past the count, as the programs
    take it). From a device count the count stays a tensor."""
    _, K, poses = seq
    eng = _engine(mode)
    m = _port(maps["index"])
    pose, Kt = torch.from_numpy(poses[2]), torch.from_numpy(K)
    full = eng.compact_now(_copy(m), pose, Kt)
    for bucket in (m.count + 100, m.data.shape[0] - 1):
        part = eng.compact_now(_copy(m, device_count), pose, Kt, bucket=bucket)
        assert isinstance(part.count, torch.Tensor) == device_count
        assert part.data.shape == m.data.shape
        assert int(part.count) == full.count < m.count
        assert torch.equal(part.data, full.data)
        assert torch.equal(part.index_image, full.index_image)
        assert torch.equal(part.index_image2, full.index_image2)


class _NoHostRead(TorchDispatchMode):
    """Raises on an op that reads a device value to the host: a scalar
    read (``.item()``, ``int()``, ``bool()``), a nonzero count, a masked
    select or a boolean-mask index."""

    BANNED = {torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
              torch.ops.aten.masked_select}
    INDEXED = {torch.ops.aten.index, torch.ops.aten.index_put, torch.ops.aten.index_put_}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        op = func.overloadpacket
        if op in self.BANNED:
            raise AssertionError(f"{func} reads to the host")
        if op in self.INDEXED and any(
                t is not None and t.dtype in (torch.bool, torch.uint8) for t in args[1]):
            raise AssertionError(f"{func} takes a boolean mask")
        return func(*args, **(kwargs or {}))


def test_no_host_read_catches_the_mask_index():
    x = torch.arange(6.0)
    with pytest.raises(AssertionError, match="boolean mask"), _NoHostRead():
        x[x > 2]
    with pytest.raises(AssertionError, match="reads to the host"), _NoHostRead():
        int(x.sum())


@pytest.mark.parametrize("mode", ["voxel", "projective", "bucketed"])
def test_compaction_reads_nothing_to_the_host(seq, maps, mode):
    """A pass on a map with a device count (voxel, projective, and the
    engine's projective pass over a bucket above the count) runs with no
    host read and gives the int-count pass's rows, count and index images,
    its count a tensor."""
    _, K, poses = seq
    m = _port(maps["index"])
    pose, Kt = torch.from_numpy(poses[2]), torch.from_numpy(K)
    eng = _engine("projective") if mode == "bucketed" else None

    def run(x):
        if mode == "voxel":
            return compact_map(x, voxel=0.03)
        if mode == "projective":
            return compact_map_projective(x, pose, Kt, height=H, width=W)
        return eng.compact_now(x, pose, Kt, bucket=m.count + 300)

    want = run(_copy(m))
    dev = _copy(m, device_count=True)
    with _NoHostRead():
        got = run(dev)
    assert isinstance(got.count, torch.Tensor)
    assert int(got.count) == want.count < m.count
    assert torch.equal(got.data, want.data)
    assert torch.equal(got.index_image, want.index_image)
    assert torch.equal(got.index_image2, want.index_image2)
