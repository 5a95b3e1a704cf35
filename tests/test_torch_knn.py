"""Parity of the port's exact KNN (``e2eslam_tpu_torch/ops/knn.py``, on the
CPU: the dispatcher plus the kernels' plain versions) with the JAX
package's Pallas KNN in interpret mode and its XLA reference; and of the
Morton sort with ``e2eslam_tpu/ops/spatial_sort.py``.

Tolerances: distances are float32 expansions ``|q|^2 - 2 q.r + |r|^2``
summed in different orders on the two sides, so they agree to a few ulps
of the cancelling terms (1e-5 absolute for unit-scale clouds). Indices
must be equal wherever the nearest neighbour is unique; where they differ,
both picks must be equally near (a tie).
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e2eslam_tpu.ops.knn  # noqa: F401  (module object fetched below)
from e2eslam_tpu.ops.knn import knn_pallas, knn_xla
from e2eslam_tpu.ops.spatial_sort import morton_codes as jax_morton
from e2eslam_tpu.ops.spatial_sort import sort_map_points as jax_sort
from e2eslam_tpu_torch.ops import knn as port_knn_mod
from e2eslam_tpu_torch.ops import spatial_sort as port_sort
from e2eslam_tpu_torch.ops.knn import knn as port_knn

JAX_KNN = sys.modules["e2eslam_tpu.ops.knn"]
ATOL = 1e-5


def _brute(q, r):
    d2 = ((q[:, None, :].astype(np.float64) - r[None, :, :]) ** 2).sum(-1)
    return d2.min(1), d2.argmin(1)


def _assert_nn(q, r, d, i, want_d, atol=ATOL):
    """Distances equal; any index is a (tied) nearest neighbour."""
    np.testing.assert_allclose(d, want_d, atol=atol, rtol=1e-5)
    via = ((q.astype(np.float64) - r[np.asarray(i)]) ** 2).sum(-1)
    np.testing.assert_allclose(via, want_d, atol=atol, rtol=1e-5)


def _port(q, r, *args, **kw):
    d, i = port_knn(torch.from_numpy(q), torch.from_numpy(r), *args, **kw)
    assert i.dtype == torch.int32
    return d.numpy(), i.numpy()


@pytest.mark.parametrize("nq,nr", [(37, 53), (300, 2500), (1024, 1024), (333, 777)])
def test_cold_matches_pallas_and_xla(nq, nr):
    rng = np.random.default_rng(0)
    q = rng.uniform(-2, 2, (nq, 3)).astype(np.float32)
    r = rng.uniform(-2, 2, (nr, 3)).astype(np.float32)
    d, i = _port(q, r)
    d_pl, i_pl = knn_pallas(jnp.asarray(q), jnp.asarray(r), interpret=True)
    d_x, _ = knn_xla(jnp.asarray(q), jnp.asarray(r))
    want, want_i = _brute(q, r)
    _assert_nn(q, r, d, i, want)
    np.testing.assert_allclose(d, np.asarray(d_pl), atol=ATOL)
    np.testing.assert_allclose(d, np.asarray(d_x), atol=ATOL)
    gap = np.sort(((q[:, None] - r[None]) ** 2).sum(-1), axis=1)
    unique = (gap[:, 1] - gap[:, 0]) > 1e-4
    np.testing.assert_array_equal(i[unique], np.asarray(i_pl)[unique])


def test_warm_seeds_never_change_the_result():
    """Correct, wrong, -1 and out-of-range seeds all give the true top-1."""
    rng = np.random.default_rng(21)
    q = rng.normal(size=(300, 3)).astype(np.float32)
    r = rng.normal(size=(1500, 3)).astype(np.float32)
    want, want_i = _brute(q, r)
    seeds = [
        want_i.astype(np.int32),
        rng.integers(0, 1500, 300).astype(np.int32),
        np.where(rng.random(300) < 0.5, want_i, -1).astype(np.int32),
        np.full(300, 5000, np.int32),
    ]
    for init in seeds:
        d, i = _port(q, r, init_idx=torch.from_numpy(init))
        d_pl, _ = knn_pallas(jnp.asarray(q), jnp.asarray(r),
                             init_idx=jnp.asarray(init), interpret=True)
        _assert_nn(q, r, d, i, want)
        np.testing.assert_allclose(d, np.asarray(d_pl), atol=ATOL)


def test_valid_counts_nr_and_nq():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1024, 3)).astype(np.float32)
    r = rng.normal(size=(2048, 3)).astype(np.float32)
    r[700:764] = q[:64]  # perfect matches in the invalid tail must be ignored
    nr, nq = 700, 300
    d, i = _port(q, r, nr, nq)
    d_pl, _ = knn_pallas(jnp.asarray(q), jnp.asarray(r), nr=nr, nq=nq, interpret=True)
    want, _ = _brute(q[:nq], r[:nr])
    _assert_nn(q[:nq], r, d[:nq], i[:nq], want)
    np.testing.assert_allclose(d[:nq], np.asarray(d_pl)[:nq], atol=ATOL)
    assert (i[:nq] < nr).all()


def test_empty_ref_set_returns_in_range_indices():
    """nr = 0 (the first keyframe's empty map): index 0 everywhere, finite
    distances, as the Pallas kernel returns; the caller's gate zeroes the
    loss."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(200, 3)).astype(np.float32)
    r = np.zeros((4096, 3), np.float32)
    for init in (None, np.full(200, 17, np.int32)):
        kw = {} if init is None else {"init_idx": torch.from_numpy(init)}
        d, i = _port(q, r, 0, **kw)
        _, i_pl = knn_pallas(jnp.asarray(q), jnp.asarray(r), nr=0,
                             init_idx=None if init is None else jnp.asarray(init),
                             interpret=True)
        assert np.isfinite(d).all()
        np.testing.assert_array_equal(i, 0)
        np.testing.assert_array_equal(np.asarray(i_pl), 0)


def _clustered(rng, n_tiles, tile, nq, q_tiles=None):
    """Refs in tight clusters of ``tile`` rows (a SLAM-like layout); queries
    near refs of the first ``q_tiles`` clusters (default: all)."""
    centers = rng.normal(size=(n_tiles, 3)) * 5.0
    r = (centers[:, None, :] + rng.normal(size=(n_tiles, tile, 3)) * 0.1).reshape(-1, 3)
    r = r.astype(np.float32)
    src = (q_tiles or n_tiles) * tile
    q = (r[rng.integers(0, src, nq)]
         + rng.normal(size=(nq, 3)) * 0.05).astype(np.float32)
    return q, r


@pytest.fixture
def small_tiles(monkeypatch):
    """Shrink the tile constants on both sides (as tests/test_knn.py does
    for the JAX module) so the candidate table, its overflow and the dense
    fallback run at toy sizes."""
    monkeypatch.setattr(JAX_KNN, "_RT", 32)
    monkeypatch.setattr(JAX_KNN, "_MAX_CAND", 8)
    monkeypatch.setattr(JAX_KNN, "_RES_MAX_ROWS", 1024)
    monkeypatch.setattr(port_knn_mod, "RT", 32)
    monkeypatch.setattr(port_knn_mod, "MAX_CAND", 8)
    monkeypatch.setattr(port_knn_mod, "RES_MAX_ROWS", 1024)
    used = []
    for name in ("dense_plain", "cand_plain", "resident_plain"):
        orig = getattr(port_knn_mod, name)

        def spy(*a, _orig=orig, _name=name, **k):
            used.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(port_knn_mod, name, spy)
    return used


@pytest.mark.parametrize("use_qperm", [False, True])
def test_candidate_table_matches_pallas(small_tiles, use_qperm):
    rng = np.random.default_rng(11)
    # Queries near one cluster (two 32-row tiles), no padded query rows: the
    # seeded table lists a few tiles and fits.
    q, r = _clustered(rng, 140, 64, 512, q_tiles=1)
    want, want_i = _brute(q, r)
    init = want_i.astype(np.int32)
    qperm = None
    if use_qperm:  # any permutation is exact
        qperm = rng.permutation(q.shape[0]).astype(np.int64)
    d, i = _port(q, r, init_idx=torch.from_numpy(init),
                 q_perm=None if qperm is None else torch.from_numpy(qperm))
    assert small_tiles == ["cand_plain"]
    d_pl, _ = knn_pallas.__wrapped__(jnp.asarray(q), jnp.asarray(r), None, None,
                                     jnp.asarray(init),
                                     None if qperm is None else jnp.asarray(qperm),
                                     interpret=True)
    _assert_nn(q, r, d, i, want, atol=1e-4)
    np.testing.assert_allclose(d, np.asarray(d_pl), atol=1e-4, rtol=1e-5)


def test_table_overflow_falls_back_to_dense(small_tiles):
    rng = np.random.default_rng(12)
    q, r = _clustered(rng, 140, 64, 130)
    want, _ = _brute(q, r)
    init = np.full(q.shape[0], -1, np.int32)  # unseeded: every tile qualifies
    d, i = _port(q, r, init_idx=torch.from_numpy(init))
    assert small_tiles == ["dense_plain"]
    d_pl, _ = knn_pallas.__wrapped__(jnp.asarray(q), jnp.asarray(r), None, None,
                                     jnp.asarray(init), interpret=True)
    _assert_nn(q, r, d, i, want, atol=1e-4)
    np.testing.assert_allclose(d, np.asarray(d_pl), atol=1e-4, rtol=1e-5)


def test_small_ref_sets_take_the_resident_kernel(small_tiles):
    rng = np.random.default_rng(13)
    q, r = _clustered(rng, 12, 64, 300)
    want, _ = _brute(q, r)
    d, i = _port(q, r)
    assert small_tiles == ["resident_plain"]
    _assert_nn(q, r, d, i, want, atol=1e-4)


@pytest.mark.parametrize("seeded", [False, True])
def test_plain_versions_agree(seeded):
    """The three plain versions compute one function on the same inputs."""
    rng = np.random.default_rng(5)
    q, r = _clustered(rng, 16, 128, 512)
    K = port_knn_mod
    q4 = torch.cat([torch.from_numpy(q), torch.ones(512, 1)], 1)
    rt = torch.from_numpy(r)
    r4 = torch.cat([rt, (-0.5 * (rt * rt).sum(1))[:, None]], 1)
    nr = 2000
    r4[nr:, 3] = K.NEG
    s0 = i0 = None
    if seeded:
        i0 = torch.from_numpy(rng.integers(0, nr, 512).astype(np.int32))
        nn0 = rt[i0.long()]
        s0 = (q4[:, :3] * nn0).sum(1) - 0.5 * (nn0 * nn0).sum(1)
    dense = K.dense_plain(q4, r4, K._tile_boxes(r4, 256), s0, i0, 512, nr, 256)
    res = K.resident_plain(q4, r4, K._tile_boxes(r4, 128), s0, i0, 512, nr, 128)
    n_qt, ntiles = 2, 2048 // 128
    cand = torch.arange(ntiles, dtype=torch.int32).repeat(n_qt, 1)
    cnt = torch.full((n_qt,), ntiles, dtype=torch.int32)
    if seeded:
        tab = K.cand_plain(q4, r4, K._tile_boxes(r4, 128), s0, i0, cand, cnt, 512, nr, 128)
    else:
        tab = dense
    want, _ = _brute(q, r[:nr])
    for s, i in (dense, res, tab):
        d = (q4[:, :3] ** 2).sum(1) - 2 * s
        _assert_nn(q, r, d.numpy(), i.numpy(), want, atol=1e-4)


def test_morton_codes_and_sort_match_jax():
    rng = np.random.default_rng(6)
    pts = rng.uniform(-3, 5, (5000, 3)).astype(np.float32)
    count = 3700
    valid = np.arange(5000) < count
    codes = port_sort.morton_codes(torch.from_numpy(pts), torch.from_numpy(valid))
    want = np.asarray(jax_morton(jnp.asarray(pts), jnp.asarray(valid)))
    np.testing.assert_array_equal(codes.numpy(), want.astype(np.int64))
    assert (codes[count:] == 0xFFFFFFFF).all() and (codes[:count] < 2**30).all()
    sm = port_sort.sort_map_points(torch.from_numpy(pts), count)
    jsm = jax_sort(jnp.asarray(pts), jnp.asarray(count, jnp.int32))
    np.testing.assert_array_equal(sm.perm.numpy(), np.asarray(jsm.perm))
    np.testing.assert_array_equal(sm.inv_perm.numpy(), np.asarray(jsm.inv_perm))
    np.testing.assert_array_equal(sm.points.numpy(), np.asarray(jsm.points))


def test_cuda_wrappers_raise_on_bad_input_and_never_fall_back():
    """On the CPU the wrappers run the plain versions and count nothing."""
    K = port_knn_mod
    before = [k.launches for k in K.KERNELS]
    q = torch.rand(100, 3)
    port_knn(q, torch.rand(300, 3))
    assert [k.launches for k in K.KERNELS] == before
    q4, r4, rbb = torch.zeros(256, 4), torch.zeros(64, 4), torch.zeros(1, 8)
    K._check(q4, r4, rbb, torch.zeros(256), torch.zeros(256, dtype=torch.int32), None, 64)
    bad = [
        (torch.zeros(100, 4), r4, rbb, None, None, None, 64),  # ragged query tile
        (q4, r4, rbb, torch.zeros(256), None, None, 64),  # seed without index
        (q4, r4, torch.zeros(2, 8), None, None, None, 64),  # boxes vs tiles
        (q4, torch.zeros(60, 4), rbb, None, None, None, 64),  # ragged ref tile
        (q4, r4, rbb, None, None, torch.zeros(3, dtype=torch.int32), 64),
        (q4, r4.double(), rbb, None, None, None, 64),
        (q4.t(), r4, rbb, None, None, None, 64),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            K._check(*args)
