"""The port's CUDA kernels on one card, against their plain versions.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed; there, skip this directory's conftest (it sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: the kernels score with fused multiply-adds in row order, the
plain versions with a matrix product, so the float32 score
``q.r - 0.5 |r|^2`` rounds differently; distances then agree to its
rounding bound (``K.fp32_distance_bound``, about ``1.7e-6 |q|^2`` for a ref
near the query). Indices must be equal wherever the nearest neighbour is
unique; where they differ, the two picks' float64 distances differ by that
bound at most.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import dataclasses

import numpy as np
import pytest
import torch

from e2eslam_tpu_torch.ops import knn as K
from torch_knn_ties import grid_tie_refs


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "python3 chip_smoke.py covers them on the card")
    from e2eslam_tpu_torch.device import set_full_fp32

    set_full_fp32()
    return torch.device("cuda")


def _clustered(rng, n_tiles, tile, nq):
    """Refs in tight clusters of ``tile`` rows (a SLAM-like layout) and
    queries near random refs."""
    centers = rng.normal(size=(n_tiles, 3)) * 5.0
    r = (centers[:, None, :] + rng.normal(size=(n_tiles, tile, 3)) * 0.1).reshape(-1, 3)
    q = r[rng.integers(0, r.shape[0], nq)] + rng.normal(size=(nq, 3)) * 0.05
    return q.astype(np.float32), r.astype(np.float32)


def _assert_same_nn(q4, r4, s_k, i_k, s_p, i_p, nq):
    q = q4[:nq, :3].double()
    q2 = (q * q).sum(1)
    r = r4[:, :3].double()
    r_k, r_p = r[i_k[:nq].long()], r[i_p[:nq].long()]
    tol = torch.maximum(K.fp32_distance_bound(q, r_k), K.fp32_distance_bound(q, r_p))
    d_k = (q2 - 2 * s_k[:nq].double()).clamp(min=0)
    d_p = (q2 - 2 * s_p[:nq].double()).clamp(min=0)
    assert bool(((d_k - d_p).abs() <= tol).all())
    gap = ((q - r_k) ** 2).sum(1) - ((q - r_p) ** 2).sum(1)
    assert bool((gap.abs() <= tol).all())


def _assert_near_oracle(q, r, d, i, nr):
    """Dispatcher results against a float64 brute force."""
    q64, r64 = q.double(), r[:nr].double()
    want = torch.empty(q.shape[0], dtype=torch.float64, device=q.device)
    for s in range(0, q.shape[0], 4096):
        want[s:s + 4096] = (torch.cdist(q64[s:s + 4096], r64) ** 2).min(1).values
    tol = K.fp32_distance_bound(q64, r[i.long()].double())
    assert bool(((d.double() - want).abs() <= tol).all())
    via = ((q64 - r[i.long()].double()) ** 2).sum(1)
    assert bool(((via - want).abs() <= tol).all())
    assert bool((i < nr).all())


def _args(dev, kernel, seeded, nr=60_000):
    """One call's arguments, as the dispatcher builds them. The candidate
    table is long and unbalanced: most query tiles list a few tiles, every
    seventh lists them all, so the kernel's split and merge both run."""
    rng = np.random.default_rng(17)
    tile = K.RT if kernel == "dense" else K.ST if kernel == "resident" else K.RT_CAND
    n_tiles = 64 * 2048 // tile
    q, r = _clustered(rng, n_tiles, tile, 3000)
    nq = 2900
    q4 = K._pad_rows(torch.cat([torch.from_numpy(q), torch.ones(3000, 1)], 1),
                     -(-3000 // K.QT) * K.QT).to(dev)
    rt = torch.from_numpy(r).to(dev)
    bias = -0.5 * (rt * rt).sum(1)
    bias[nr:] = K.NEG
    r4 = torch.cat([rt, bias[:, None]], 1).contiguous()
    box = min(K.walk_config()["chunk"], tile) if kernel == "resident" else tile
    rbb = K._tile_boxes(r4[:, :3], box)
    s0 = i0 = None
    if seeded:
        g = torch.Generator(device="cpu").manual_seed(3)
        i0 = torch.randint(0, nr, (q4.shape[0],), generator=g, dtype=torch.int32).to(dev)
        nn0 = rt[i0.long()]
        s0 = ((q4[:, :3] * nn0).sum(1) - 0.5 * (nn0 * nn0).sum(1)).contiguous()
    if kernel == "cand":
        n_qt, n_rt = q4.shape[0] // K.QT, r4.shape[0] // tile
        g = torch.Generator(device="cpu").manual_seed(4)
        cand = torch.stack([torch.randperm(n_rt, generator=g)
                            for _ in range(n_qt)]).to(torch.int32).to(dev)
        cnt = torch.randint(0, 5, (n_qt,), generator=g, dtype=torch.int32)
        cnt[::7] = n_rt
        return (q4, r4, rbb, s0, i0, cand, cnt.to(dev), nq, nr, tile)
    return (q4, r4, rbb, s0, i0, nq, nr, tile)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,seeded", [("dense", False), ("dense", True),
                                           ("resident", False), ("resident", True),
                                           ("cand", True)])
def test_kernel_matches_its_plain_version(card, kernel, seeded):
    """Each wrapper launches its kernel once (and counts it) and agrees with
    its plain version on the same card tensors."""
    wrapper = getattr(K, f"{kernel}_kernel")
    plain = getattr(K, f"{kernel}_plain")
    nr = 60_000 if kernel != "resident" else 30_000
    args = _args(card, kernel, seeded, nr)
    before = wrapper.launches
    s_k, i_k = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    s_p, i_p = plain(*args)
    nq = args[-3]
    _assert_same_nn(args[0], args[1], s_k, i_k, s_p, i_p, nq)
    assert bool((i_k[:nq] < nr).all() & (i_k[:nq] >= 0).all())
    # The visit record, per work item: ref rows staged, pairs scored, and the
    # pairs another share scores too. Counted once, the pairs are at most
    # every (query row, ref row) pair.
    n_qt = args[0].shape[0] // K.QT
    visits = torch.zeros(K.walk_items_max(n_qt), 3, dtype=torch.int64, device=card)
    s_v, _ = wrapper(*args, visits=visits)
    assert torch.equal(s_v, s_k)
    rows, pairs, repeated = visits.sum(0).tolist()
    assert 0 < pairs <= rows * K.QT and 0 <= repeated < pairs
    assert pairs - repeated <= args[0].shape[0] * args[1].shape[0]
    if kernel != "resident":
        assert repeated == 0


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(card):
    """The dispatcher on the card (kernels) against a float64 brute force,
    cold and warm."""
    rng = np.random.default_rng(7)
    q, r = _clustered(rng, 200, 512, 1024)
    qc, rc = torch.from_numpy(q).to(card), torch.from_numpy(r).to(card)
    for init in (None, torch.full((1024,), -1, dtype=torch.int32, device=card)):
        d, i = K.knn(qc, rc, init_idx=init)
        _assert_near_oracle(qc, rc, d, i, rc.shape[0])


@pytest.mark.cuda
def test_wrappers_raise_on_card_tensors_they_cannot_take(card):
    """On a CUDA tensor a wrapper launches or raises; it never runs the
    plain version instead."""
    args = list(_args(card, "dense", True))
    args[1] = args[1].double()
    before = K.dense_kernel.launches
    with pytest.raises(ValueError):
        K.dense_kernel(*args)
    assert K.dense_kernel.launches == before
    # Tiles the walk kernels' shape, read from the built library, does not
    # divide are refused before launch.
    cfg = K.walk_config()
    args = list(_args(card, "dense", True))
    rt = cfg["chunk"] + cfg["group"]
    args[1], args[-1] = args[1][:rt * (args[1].shape[0] // rt)].contiguous(), rt
    args[2] = K._tile_boxes(args[1][:, :3], rt)
    with pytest.raises(ValueError):
        K.dense_kernel(*args)
    qt, K.QT = K.QT, 32 * cfg["qpt"] + 32  # not a multiple of the query group
    try:
        with pytest.raises(ValueError):
            K.dense_kernel(*_args(card, "dense", True))
    finally:
        K.QT = qt
    assert K.dense_kernel.launches == before


@pytest.mark.cuda
def test_split_merge_keeps_the_sequential_tie_rule_on_the_card(card):
    """Exact ties across a split list: queries sit on ref rows that two
    listed tiles both hold. The kernel (its list split over several blocks)
    must pick the earlier table position, as ``cand_plain`` does."""
    rng = np.random.default_rng(19)
    rt, n_tiles, n_qt = K.RT_CAND, 12, 2
    r = rng.uniform(-1, 1, (n_tiles * rt, 3)).astype(np.float32)
    r[9 * rt:10 * rt] = r[2 * rt:3 * rt]
    rows = np.concatenate([rng.integers(2 * rt, 3 * rt, K.QT),
                           rng.integers(0, n_tiles * rt, K.QT)])
    q = r[rows]
    rt_ = torch.from_numpy(r).to(card)
    q4 = torch.cat([torch.from_numpy(q), torch.ones(n_qt * K.QT, 1)], 1).to(card)
    r4 = torch.cat([rt_, (-0.5 * (rt_ * rt_).sum(1))[:, None]], 1).contiguous()
    nr = r4.shape[0]
    i0 = torch.from_numpy(rng.integers(0, nr, n_qt * K.QT).astype(np.int32)).to(card)
    s0 = ((q4[:, :3] * rt_[i0.long()]).sum(1) - 0.5 * (rt_[i0.long()] ** 2).sum(1))
    order = [[5, 9, 0, 1, 2, 3, 4, 6, 7, 8, 10, 11], [2, 5, 0, 1, 3, 4, 6, 7, 9, 8, 10, 11]]
    cand = torch.tensor(order, dtype=torch.int32, device=card)
    cnt = torch.tensor([12, 12], dtype=torch.int32, device=card)
    rbb = K._tile_boxes(r4[:, :3], rt)
    args = (q4, r4, rbb, s0.contiguous(), i0, cand, cnt, n_qt * K.QT, nr, rt)
    s_k, i_k = K.cand_kernel(*args)
    s_p, i_p = K.cand_plain(*args)
    assert torch.equal(i_k, i_p)
    assert bool((i_k[:K.QT].long() // rt == 9).all())  # tile 9 is listed first


def _resident_ties(dev, st=512, n_sub=9, cut=20):
    """The exact-tie inputs (``torch_knn_ties``) on the card; ``nr`` ends
    ``cut`` rows inside the last sub-tile."""
    rng = np.random.default_rng(18)
    q4, r4 = grid_tie_refs(rng, st, n_sub, 4, K.QT)
    nr = n_sub * st - cut
    r4[nr:, 3] = K.NEG
    return q4.to(dev), r4.to(dev).contiguous(), q4.shape[0] - 5, nr


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 3, 5])
@pytest.mark.parametrize("seeded", [False, True])
def test_resident_kernel_keeps_the_tie_rule_across_splits(card, monkeypatch, splits, seeded):
    """Exact ties (duplicate refs in two sub-tiles and within one, seeds
    tied with the best) with each query group's list split over several
    work items: the kernel's result equals ``resident_plain`` bit for bit."""
    monkeypatch.setattr(K, "RES_SPLIT_MIN", 1)
    monkeypatch.setattr(K, "RES_MAX_SPLITS", splits)
    st = 512
    q4, r4, nq, nr = _resident_ties(card, st)
    s0 = i0 = None
    if seeded:
        g = torch.Generator(device="cpu").manual_seed(5)
        i0 = torch.randint(0, nr, (q4.shape[0],), generator=g, dtype=torch.int32).to(card)
        i0[:40] = 2 * st
        r = r4[:, :3]
        s0 = ((q4[:, :3] * r[i0.long()]).sum(1) - 0.5 * (r[i0.long()] ** 2).sum(1)).contiguous()
    args = (q4, r4, K._tile_boxes(r4[:, :3], K.walk_config()["chunk"]), s0, i0, nq, nr, st)
    s_k, i_k = K.resident_kernel(*args)
    s_p, i_p = K.resident_plain(*args)
    assert torch.equal(s_k[:nq], s_p[:nq]) and torch.equal(i_k[:nq], i_p[:nq])
    if not seeded:
        assert bool((i_k[:K.QT].long() // st == 6).all())  # the list starts at 6


@pytest.mark.cuda
def test_resident_kernel_ignores_rows_past_nr_inside_a_subtile(card):
    """``nr`` ends inside a sub-tile whose rows past it repeat the queries
    exactly: the kernel keeps that sub-tile's valid rows and never picks a
    row past ``nr``."""
    q4, r4, nq, nr = _resident_ties(card, cut=300)
    r4[nr:nr + 256, :3] = q4[:256, :3]
    r4[nr:nr + 256, 3] = K.NEG
    args = (q4, r4, K._tile_boxes(r4[:, :3], K.walk_config()["chunk"]), None, None, nq, nr,
            512)
    s_k, i_k = K.resident_kernel(*args)
    s_p, i_p = K.resident_plain(*args)
    assert torch.equal(s_k[:nq], s_p[:nq]) and torch.equal(i_k[:nq], i_p[:nq])
    assert bool((i_k[:nq] < nr).all())
    assert bool((i_k[:nq].long() // 512 == nr // 512).any())  # the cut sub-tile still wins


@pytest.mark.cuda
def test_resident_kernel_with_a_far_outlier_query(card):
    """One query far from the refs in a query group of near ones (its group
    cannot prune, the others can): every result is exact."""
    rng = np.random.default_rng(29)
    q, r = _clustered(rng, 64, K.ST, 3000)
    q[1000] = [60.0, -60.0, 60.0]
    qc, rc = torch.from_numpy(q).to(card), torch.from_numpy(r).to(card)
    before = K.resident_kernel.launches
    d, i = K.knn(qc, rc)
    assert K.resident_kernel.launches == before + 1
    _assert_near_oracle(qc, rc, d, i, rc.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("with_perm", [False, True])
def test_warm_knn_makes_no_host_synchronisation(card, with_perm):
    """A warm frame->map call (81,920 queries, refs past the resident
    kernel's limit) takes the candidate table and never waits on the card."""
    rng = np.random.default_rng(23)
    q, r = _clustered(rng, 200, 2048, 81920)
    qc, rc = torch.from_numpy(q).to(card), torch.from_numpy(r).to(card)
    nr = r.shape[0] - 1000
    _, i_cold = K.knn(qc, rc, nr)
    init = torch.where(torch.rand(81920, device=card) < 0.9, i_cold, -1)
    perm = torch.randperm(81920, device=card) if with_perm else None
    K.knn(qc, rc, nr, init_idx=init, q_perm=perm)  # loads the library
    torch.cuda.synchronize()
    before = [k.launches for k in K.KERNELS]
    torch.cuda.set_sync_debug_mode("error")
    try:
        d, i = K.knn(qc, rc, nr, init_idx=init, q_perm=perm)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [k.launches - b for k, b in zip(K.KERNELS, before)] == [0, 1, 0]
    _assert_near_oracle(qc, rc, d, i, nr)


def _map_to_frame(dev, n_qt=2100, H=256, W=320):
    """The chamfer's map->frame call: Morton-sorted points on the walls of a
    4 x 3 x 5 m box query the frame one camera inside it sees (H x W pixels,
    one in ten invalid, at the 1e4 sentinel), seeded by the pixel each map
    point projects to, half of the seeds none."""
    from e2eslam_tpu_torch.ops.spatial_sort import sort_map_points

    g = torch.Generator(device=dev).manual_seed(31)
    box = torch.tensor([4.0, 3.0, 5.0], device=dev)
    cam = torch.tensor([2.0, 1.5, 0.5], device=dev)
    f = 0.8 * W
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32), indexing="ij")
    rays = torch.stack([(xs - W / 2) / f, (ys - H / 2) / f, torch.ones_like(xs)], -1).reshape(-1, 3)
    exits = torch.where(rays > 0, (box - cam) / rays, torch.where(rays < 0, -cam / rays,
                                                                   torch.full_like(rays, 1e9)))
    frame = cam + rays * exits.amin(1, keepdim=True)
    frame[torch.rand(H * W, generator=g, device=dev) < 0.1] = 1e4
    n = n_qt * K.QT
    p = torch.rand(n, 3, generator=g, device=dev) * box
    axis = torch.randint(0, 3, (n,), generator=g, device=dev)
    side = torch.randint(0, 2, (n,), generator=g, device=dev).float()
    p[torch.arange(n, device=dev), axis] = side * box[axis]
    pts = sort_map_points(p, n).points
    rel = pts - cam
    z = rel[:, 2].clamp(min=1e-3)
    u = (rel[:, 0] / z * f + W / 2).round().long().clamp(0, W - 1)
    v = (rel[:, 1] / z * f + H / 2).round().long().clamp(0, H - 1)
    seeds = torch.where(torch.rand(n, generator=g, device=dev) < 0.5, v * W + u, -1)
    return pts, frame, seeds


def _resident_args(q, r, seeds, nq):
    """The resident kernel's arguments, as the dispatcher builds them."""
    nr = r.shape[0]
    q4 = torch.cat([q, torch.ones_like(q[:, :1])], 1).contiguous()
    r4 = torch.cat([r, -0.5 * (r * r).sum(1, keepdim=True)], 1).contiguous()
    ok = seeds >= 0
    nn0 = r[seeds.clamp(min=0)]
    s0 = torch.where(ok, (q * nn0).sum(1) - 0.5 * (nn0 * nn0).sum(1), K.NEG).contiguous()
    i0 = torch.where(ok, seeds, 0).int().contiguous()
    rbb = K._tile_boxes(r, min(K.walk_config()["chunk"], K.ST))
    return q4, r4, rbb, s0, i0, nq, nr, K.ST


@pytest.mark.cuda
@pytest.mark.parametrize("nq_cut", [100, None])
def test_resident_kernel_at_the_map_to_frame_shape(card, nq_cut):
    """2,100 query tiles of map points against 81,920 frame refs: the kernel
    agrees with its plain version (run 64 query tiles at a time: a query
    tile's list depends on that tile alone) on the valid rows, with ``nq``
    inside the last tile, or ``nq = 0`` (the first keyframe's empty map),
    where every row keeps its seed and no pair is scored."""
    q, r, seeds = _map_to_frame(card)
    nq = q.shape[0] - nq_cut if nq_cut else 0
    args = _resident_args(q, r, seeds, nq)
    before = K.resident_kernel.launches
    s_k, i_k = K.resident_kernel(*args)
    torch.cuda.synchronize()
    assert K.resident_kernel.launches == before + 1
    if nq == 0:
        assert torch.equal(s_k, args[3]) and torch.equal(i_k, args[4])
    else:
        step = 64 * K.QT
        parts = [K.resident_plain(args[0][s:s + step], args[1], args[2], args[3][s:s + step],
                                  args[4][s:s + step], min(step, nq - s), args[6], K.ST)
                 for s in range(0, q.shape[0], step)]
        s_p, i_p = (torch.cat(t) for t in zip(*parts))
        _assert_same_nn(args[0], args[1], s_k, i_k, s_p, i_p, nq)
        assert bool((r[i_k[:nq].long(), 0] < 100).all())  # no valid query picks a sentinel
    visits = torch.zeros(K.walk_items_max(q.shape[0] // K.QT), 3, dtype=torch.int64,
                         device=card)
    K.resident_kernel(*args, visits=visits)
    rows, pairs, repeated = visits.sum(0).tolist()
    assert pairs - repeated <= max(nq, 0) * r.shape[0]
    assert (pairs > 0) == (nq > 0)
    # Through the dispatcher, a warm call of 81,920 refs takes the resident kernel.
    before = [k.launches for k in K.KERNELS]
    d, i = K.knn(q, r, nq=nq, init_idx=seeds)
    assert [k.launches - b for k, b in zip(K.KERNELS, before)] == [0, 0, 1]
    if nq:
        assert torch.equal(i[:nq], i_k[:nq])


def _shared_slot_map(device):
    """A plane at 2 m seen head-on, and a 64-point map whose index image
    gives every 8x8 block of pixels one slot: up to 64 similar pixels blend
    into each slot."""
    from e2eslam_tpu_torch.slam.fusion import frame_pointcloud
    from e2eslam_tpu_torch.slam.pointclouds import map_from_arrays
    from e2eslam_tpu_torch.slam.rgbd import build_frame

    H = W = 64
    rng = np.random.default_rng(3)
    K4 = torch.tensor([[50.0, 0, 32, 0], [0, 50.0, 32, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    color = torch.from_numpy(rng.random((H, W, 3)).astype(np.float32))
    frame = build_frame(color.to(device), torch.full((H, W, 1), 2.0, device=device),
                        K4.to(device), torch.eye(4, device=device))
    live = frame_pointcloud(frame)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    slot = ((ys // 8) * (W // 8) + xs // 8).reshape(-1).astype(np.int32)
    centre = ((np.arange(64) // 8) * 8 + 4) * W + (np.arange(64) % 8) * 8 + 4
    data = np.zeros((64 + H * W, 16), np.float32)
    data[:64, 0:3] = live.points.cpu().numpy()[centre] + 0.01 * rng.normal(size=(64, 3))
    data[:64, 3:6] = live.normals.cpu().numpy()[centre]
    data[:64, 6:9] = rng.random((64, 3))
    data[:64, 9] = rng.uniform(0.5, 3.0, 64)
    fields = dict(data=data, count=64, index_image=slot, index_pose=np.eye(4, dtype=np.float32))
    return map_from_arrays(fields, device=device), frame


@pytest.mark.cuda
def test_index_fusion_on_the_card_matches_the_cpu(card):
    """Index fusion where many pixels share slots: the card's result equals
    the CPU's (index images and counts equal, rows to 1e-6, float32 blends
    in another order), and two card runs give the same bytes (duplicate
    slots resolve by the highest pixel, not by the order of writes)."""
    from e2eslam_tpu_torch.slam.fusion import pointfusion_step_index

    runs = []
    for device in (card, card, torch.device("cpu")):
        m, frame = _shared_slot_map(device)
        runs.append(pointfusion_step_index(m, frame, dist_th=1.0))
    a, b, c = runs
    assert torch.equal(a.data, b.data) and torch.equal(a.index_image, b.index_image)
    assert a.count == c.count
    assert torch.equal(a.index_image.cpu(), c.index_image)
    assert bool((a.index_image < 64).sum() > 3000)  # most pixels merged
    torch.testing.assert_close(a.data.cpu()[: a.count], c.data[: c.count], rtol=0, atol=1e-6)


def _fusion_inputs(device, count, N, seed=11):
    """``chip_smoke.fusion_scene`` at 64x48: a live frame and a map of ``N``
    rows, the first ``count`` valid (merges, gate failures, exact ties)."""
    from chip_smoke import fusion_scene

    return fusion_scene(count, N, seed, H=48, W=64, device=device)


def _plain_fusion(m, frame, **kw):
    """The plain PyTorch path on the same card tensors (the functional
    form: the in-place call on a card takes the kernels)."""
    from e2eslam_tpu_torch.slam import fusion

    kw = {"dist_th": 0.05, "angle_th": 20.0, "sigma": 0.6, "active_window": None,
          "active": None, **kw}
    with torch.no_grad():
        return fusion._pointfusion_step(m, frame, kw["dist_th"], kw["angle_th"], kw["sigma"],
                                        kw["active_window"], kw["active"], inplace=False)


def _fusion_gaps(before, kern, plain):
    """Kernel against plain on one fusion (``chip_smoke.fusion_gaps``): the
    count, the winner set (the rows whose confidence changed), the appended
    rows and the zeros past the count equal; merged rows within 1e-6; every
    other row's bytes kept by the kernel and within two ulps of the plain
    path's renormalised normal (renormalising a float32 unit normal moves a
    component by up to two ulps: seen at 3M rows in the fusion phase of
    ``chip_smoke.py``). Returns (rows merged, rows appended)."""
    from chip_smoke import fusion_gaps

    g = fusion_gaps(before, kern, plain)
    assert g["count"] == g["plain_count"] and g["rows_differ"] == 0, g
    assert g["appended_equal"] and g["tail_zero"] and g["kept_bytes"], g
    assert g["merged_gap"] <= 1e-6 and g["kept_normal_ulps"] <= 2, g
    return g["merged"], g["appended"]


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["host_count", "device_count", "count_far_below_n"])
def test_fusion_kernel_matches_the_plain_path(card, where):
    """The CUDA fusion kernels (``ops/pointfusion.py``) against the plain
    path on the same card inputs: ties and merges on a small map with a
    host count, the same with a device count, and a count far below the
    buffer's rows; each call launches once."""
    from e2eslam_tpu_torch.ops.pointfusion import fusion_kernel
    from e2eslam_tpu_torch.slam.fusion import pointfusion_step
    from e2eslam_tpu_torch.slam.pointclouds import on_device

    HW = 48 * 64
    count, N = (HW // 2, 40 * HW) if where == "count_far_below_n" else (2 * HW, 4 * HW)
    m, frame = _fusion_inputs(card, count, N)
    if where != "host_count":
        m = on_device(m)
    before = fusion_kernel.launches
    with torch.no_grad():
        kern = pointfusion_step(dataclasses.replace(m, data=m.data.clone()), frame)
    assert fusion_kernel.launches == before + 1
    plain = _plain_fusion(m, frame)
    assert fusion_kernel.launches == before + 1
    merged, appended = _fusion_gaps(m, kern, plain)
    assert merged > 200 and appended > 200
    assert isinstance(kern.count, torch.Tensor) == (where != "host_count")


@pytest.mark.cuda
def test_fusion_kernel_leaves_an_inactive_map_as_it_was(card):
    """``active`` False: the map's bytes and count come out unchanged and
    nothing is read to the host; True: the plain path's result."""
    from e2eslam_tpu_torch.slam.fusion import pointfusion_step
    from e2eslam_tpu_torch.slam.pointclouds import on_device

    m, frame = _fusion_inputs(card, 2 * 48 * 64, 4 * 48 * 64)
    m = on_device(m)
    for flag in (False, True):
        active = torch.full((), flag, dtype=torch.bool, device=card)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                kern = pointfusion_step(dataclasses.replace(m, data=m.data.clone()), frame,
                                        active=active)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if not flag:
            assert torch.equal(kern.data, m.data) and int(kern.count) == int(m.count)
        else:
            _fusion_gaps(m, kern, _plain_fusion(m, frame, active=active))


@pytest.mark.cuda
@pytest.mark.parametrize("device_count", [False, True])
def test_fusion_kernel_with_an_active_window(card, device_count):
    """An active window of the newest rows, its start read on the host or
    on the card: the same fusion as the plain path's window."""
    from e2eslam_tpu_torch.slam.fusion import pointfusion_step
    from e2eslam_tpu_torch.slam.pointclouds import on_device

    HW = 48 * 64
    m, frame = _fusion_inputs(card, 2 * HW, 4 * HW, seed=12)
    if device_count:
        m = on_device(m)
    for window in (HW, 3 * HW):  # inside the valid rows; reaching past the count
        with torch.no_grad():
            kern = pointfusion_step(dataclasses.replace(m, data=m.data.clone()), frame,
                                    active_window=window)
        merged, _ = _fusion_gaps(m, kern, _plain_fusion(m, frame, active_window=window))
        assert merged > 100
        won = (kern.data[:2 * HW, 9] != m.data[:2 * HW, 9]).nonzero()
        assert int(won.min()) >= 2 * HW - window


@pytest.mark.cuda
def test_fusion_kernel_raises_on_card_tensors_it_cannot_take(card):
    """An in-place fusion on a card launches the kernels or raises (here a
    float64 map); it never runs the plain path instead."""
    from e2eslam_tpu_torch.ops.pointfusion import fusion_kernel
    from e2eslam_tpu_torch.slam.fusion import pointfusion_step

    m, frame = _fusion_inputs(card, 2 * 48 * 64, 4 * 48 * 64)
    before = fusion_kernel.launches
    with pytest.raises(ValueError), torch.no_grad():
        pointfusion_step(dataclasses.replace(m, data=m.data.double()), frame)
    assert fusion_kernel.launches == before


@pytest.mark.cuda
def test_captured_fusion_kernel_replays_the_eager_call(card):
    """The fusion kernels captured in a CUDA graph with a device count:
    each replay equals the eager call from the same map, follows the count
    the previous replay left, and neither makes a host synchronisation."""
    from e2eslam_tpu_torch.slam.fusion import pointfusion_step
    from e2eslam_tpu_torch.slam.pointclouds import on_device

    HW = 48 * 64
    m, frame = _fusion_inputs(card, 2 * HW, 5 * HW, seed=13)
    m = on_device(m)
    _, frame2 = _fusion_inputs(card, 1, 5 * HW, seed=14)
    eager = [dataclasses.replace(m, data=m.data.clone())]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            for f in (frame, frame2):
                eager.append(pointfusion_step(dataclasses.replace(
                    eager[-1], data=eager[-1].data.clone()), f))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    live = dataclasses.replace(m, data=m.data.clone(), count=m.count.clone())
    inputs = [t.clone() for t in (frame.vertices, frame.normals, frame.color, frame.depth,
                                  frame.valid, frame.pose)]
    static = frame._replace(vertices=inputs[0], normals=inputs[1], color=inputs[2],
                            depth=inputs[3], valid=inputs[4], pose=inputs[5])
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph):
        out = pointfusion_step(live, static)
        live.count.copy_(out.count)
    for i, f in enumerate((frame, frame2)):
        for t, src in zip(inputs, (f.vertices, f.normals, f.color, f.depth, f.valid, f.pose)):
            t.copy_(src)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert int(live.count) == int(eager[i + 1].count)
        assert torch.equal(live.data, eager[i + 1].data)


def _icp_inputs(device, n_live=4096):
    """A plane 1 m in front of the camera seen twice, the live view 2 cm
    farther: the camera-frame inputs of one ICP solve."""
    from e2eslam_tpu_torch.core.camera import inverse_intrinsics
    from e2eslam_tpu_torch.core.projection import backproject
    from e2eslam_tpu_torch.slam.rgbd import normal_map

    K_ = torch.tensor([[60.0, 0, 32, 0], [0, 60, 32, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    yy, xx = torch.meshgrid(torch.arange(64.0), torch.arange(64.0), indexing="ij")
    depth = (1.0 + 0.002 * xx + 0.001 * yy)[..., None]
    tgt = backproject(depth[None], inverse_intrinsics(K_)[None])[0]
    src = backproject((depth + 0.02)[None], inverse_intrinsics(K_)[None])[0].reshape(-1, 3)
    args = (src[:n_live], torch.ones(n_live), tgt, normal_map(tgt), torch.ones(64, 64), K_)
    return tuple(a.to(device) for a in args)


@pytest.mark.cuda
@pytest.mark.parametrize("soft", [True, False], ids=["gradicp", "icp"])
def test_icp_holds_the_pose_on_a_failed_factorisation(card, soft):
    """A negative damping makes every 6x6 system indefinite: the Cholesky
    factorisation fails (``cholesky_ex`` leaves a finite partial factor) and
    every iteration holds the initial transform; with a valid damping the
    same solve moves it. The loop reads nothing back to the host: no sync
    PyTorch makes (``set_sync_debug_mode``), and none inside the solver
    library either: queued behind a spin kernel of about a second, a
    two-iteration solve is enqueued long before the card reaches it. (Two:
    20 iterations are ~4,000 launches, past the depth of the card's launch
    queue, so the host would wait for room in it, not for a result.)"""
    import time

    from e2eslam_tpu_torch.slam.odometry import point_to_plane_icp

    args = _icp_inputs(card)
    init = torch.eye(4, device=card)
    point_to_plane_icp(*args, numiters=2, soft=soft)  # warm-up (loads the solver)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        held = point_to_plane_icp(*args, numiters=5, soft=soft, damping=-1e6, init_T=init)
        moved = point_to_plane_icp(*args, numiters=5, soft=soft, init_T=init)
        torch.cuda._sleep(2_000_000_000)  # ~1 s of spinning at the H100's clock
        t0 = time.perf_counter()
        point_to_plane_icp(*args, numiters=2, soft=soft)
        enqueue_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        waited_s = time.perf_counter() - t1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(held.cpu(), init.cpu())
    assert float((moved - init).abs().max()) > 1e-3 and bool(torch.isfinite(moved).all())
    assert waited_s > 0.2 and enqueue_s < waited_s, (enqueue_s, waited_s)


@pytest.mark.cuda
def test_voxel_index_on_the_card_equals_the_cpu(card):
    """The voxel hash built on the card equals the CPU-built one bit for
    bit, and so do the searches through it."""
    from e2eslam_tpu_torch.ops.voxel_knn import build_voxel_index, voxel_knn

    rng = np.random.default_rng(29)
    p = rng.uniform(-50, 50, (200_000, 3)).astype(np.float32)
    p[:100_000] = p[100_000:] + rng.normal(scale=0.05, size=(100_000, 3)).astype(np.float32)
    q = (p[rng.integers(0, 200_000, 50_000)]
         + rng.normal(scale=0.05, size=(50_000, 3))).astype(np.float32)
    out = []
    for dev in (card, torch.device("cpu")):
        idx = build_voxel_index(torch.from_numpy(p).to(dev), 190_000, 0.1, table_size=1 << 18)
        out.append((idx, voxel_knn(torch.from_numpy(q).to(dev), idx)))
    (a, ra), (b, rb) = out
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y)
    for x, y in zip(ra, rb):
        assert torch.equal(x.cpu(), y)
    assert bool(rb[2].float().mean() > 0.5)


def _dup_map(device, n=300_000, seed=31):
    """A map with duplicate surfels: half its rows re-observe the other
    half 1-8 mm off, with index images of two levels over the rows."""
    from e2eslam_tpu_torch.slam.pointclouds import map_from_arrays

    rng = np.random.default_rng(seed)
    half = n // 2
    p = rng.uniform(0.0, 5.0, (half, 3)).astype(np.float32)
    p[:, 2] += 1.0
    pts = np.concatenate([p, p + rng.normal(scale=0.004, size=p.shape).astype(np.float32)])
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm[half:] = nrm[:half] + rng.normal(scale=0.05, size=(half, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    data = np.zeros((n + 1000, 16), np.float32)
    data[:n, 0:3], data[:n, 3:6] = pts, nrm
    data[:n, 6:9] = rng.random((n, 3))
    data[:n, 9] = rng.uniform(0.5, 3.0, n)
    slots = rng.integers(-1, n, 4096).astype(np.int32)
    fields = dict(data=data, count=n, index_image=slots, index_pose=np.eye(4, dtype=np.float32),
                  index_image2=np.roll(slots, 7), index_pose2=np.eye(4, dtype=np.float32),
                  kf_counter=3)
    return map_from_arrays(fields, device=device)


@pytest.mark.cuda
def test_compaction_on_the_card_matches_the_cpu(card):
    """The voxel pass on the card keeps the same rows as the CPU's (counts,
    index images equal; rows to 1e-5, the weighted sums added in another
    order) and repeats to the byte under deterministic algorithms; the
    projective pass's counts part by at most 1e-3 (K.p/z rounds to another
    pixel now and then) and its index images stay consistent."""
    from e2eslam_tpu_torch.slam.compact import compact_map, compact_map_projective

    K_ = torch.tensor([[200.0, 0, 160, 0], [0, 200, 128, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    pose = torch.eye(4)
    cpu = compact_map(_dup_map("cpu"), voxel=0.01)
    torch.use_deterministic_algorithms(True)
    try:
        a, b = (compact_map(_dup_map(card), voxel=0.01) for _ in range(2))
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(a.data, b.data) and a.count == b.count
    assert a.count == cpu.count < 300_000
    for name in ("index_image", "index_image2"):
        assert torch.equal(getattr(a, name).cpu(), getattr(cpu, name))
    torch.testing.assert_close(a.data.cpu(), cpu.data, rtol=0, atol=1e-5)
    pc = compact_map_projective(_dup_map("cpu"), pose, K_, height=256, width=320)
    pg = compact_map_projective(_dup_map(card), pose.to(card), K_.to(card), height=256,
                                width=320)
    assert pc.count < 300_000 and abs(pg.count - pc.count) <= 1e-3 * pc.count
    for m in (pg, pc):
        for img in (m.index_image, m.index_image2):
            assert bool(((img >= -1) & (img < m.count)).all())


def _offline_engine(device, over):
    """A 64x64 engine (the port's own seeded weights) on ``device``, a window
    of the synthetic scene and its ground-truth map."""
    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.data.synthetic import SyntheticDataset
    from e2eslam_tpu_torch.engine.refine import PairBatch, RefinementEngine
    from e2eslam_tpu_torch.models.depth_net import make_depth_model
    from e2eslam_tpu_torch.slam.slam import PointFusion

    H = W = 64
    cfg = load_yaml(default_config_path())
    cfg.DATA.height, cfg.DATA.width = H, W
    for k, v in over.items():
        sec, flag = k.split(".")
        cfg[sec][flag] = v
    colors, depths, Kin, poses, _ = SyntheticDataset(seqlen=2, height=H, width=W, dilation=3,
                                                     total_frames=20)[0]
    pair = PairBatch(*(torch.from_numpy(np.array(x, np.float32)).to(device)
                       for x in (colors / 255.0, depths, Kin, poses)))
    engine = RefinementEngine(cfg, make_depth_model(cfg), map_capacity=2 * H * W, device=device)
    with torch.no_grad():
        gt_map, _ = PointFusion(odom="gt")(pair.colors, pair.gt_depths, pair.intrinsics,
                                           pair.poses, capacity=2 * H * W)
    return engine, pair, gt_map


@pytest.mark.cuda
def test_oft_and_scale_steps_on_the_card_match_the_cpu(card):
    """One OFT step (brute three3d through the resident and candidate
    kernels on the card) and one SCALE step, card against CPU: loss terms to
    rtol 1e-4, the depths to rtol 1e-4 or 5.3e-5 (tests/test_torch_oft_scale.py's
    DEPTH_ATOL: Adam's step of a pixel whose gradient is of eps's order), the
    learned scale and bias to rtol 1e-4."""
    oft = {"LOSS.smoothness": True, "OPTIMIZATION.learning_rate": 1e-3,
           "ABLATION.scaled_depth_mode": "constant", "ABLATION.scaling_depth": 1.0}
    out = {}
    for dev in (card, torch.device("cpu")):
        engine, pair, gt_map = _offline_engine(dev, oft)
        _, frozen = engine.predict_depth(pair.colors)
        initial = engine.apply_scaling(frozen, pair.gt_depths, pair.intrinsics)
        state = engine.oft_state(frozen)
        before = [k.launches for k in K.KERNELS]
        m = engine.oft_step(state, initial, pair, gt_map, engine.build_map_index(gt_map))
        launched = [k.launches - b for k, b in zip(K.KERNELS, before)]
        out[dev.type] = (state.depths.detach().cpu(), {k: float(v) for k, v in m.items()},
                         launched)
    (d_gpu, m_gpu, launched), (d_cpu, m_cpu, _) = out["cuda"], out["cpu"]
    # The tail seed and the search: at 64x64 the 8,192-row map is the
    # resident kernel's, both calls.
    assert launched == [0, 0, 2]
    for k in ("photometric", "smoothness", "three3d", "total_loss"):
        np.testing.assert_allclose(m_gpu[k], m_cpu[k], rtol=1e-4, err_msg=k)
    torch.testing.assert_close(d_gpu, d_cpu, rtol=1e-4, atol=5.3e-5)
    scale = {"LOSS.three3d_loss": False, "LOSS.smoothness": True,
             "OPTIMIZATION.learning_rate": 1e-2, "ABLATION.scaled_depth": False}
    learned = {}
    for dev in (card, torch.device("cpu")):
        engine, pair, _ = _offline_engine(dev, scale)
        sc = engine.scale_state(2.0, True)
        m = engine.scale_step(sc, pair, engine.make_empty_map(),
                              engine.predict_depth(pair.colors))
        learned[dev.type] = ({k: float(v.detach()) for k, v in sc.params.items()},
                             float(m["total_loss"]))
    for k in ("scale", "bias"):
        np.testing.assert_allclose(learned["cuda"][0][k], learned["cpu"][0][k], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(learned["cuda"][1], learned["cpu"][1], rtol=1e-4)


@pytest.mark.cuda
def test_dense_kernel_at_the_recover_call_shape(card):
    """The gradient-flow experiment's cold call at 320x256: 163,840 buffer
    rows query 163,840 (past RES_MAX_ROWS, so the dispatcher takes the dense
    kernel), refs and queries on box walls; the kernel against dense_plain
    on the same card tensors."""
    g = torch.Generator(device=card).manual_seed(5)
    n = 2 * 320 * 256
    box = torch.tensor([4.0, 3.0, 5.0], device=card)

    def walls(m):
        p = torch.rand(m, 3, generator=g, device=card) * box
        axis = torch.randint(0, 3, (m,), generator=g, device=card)
        side = torch.randint(0, 2, (m,), generator=g, device=card).float()
        p[torch.arange(m, device=card), axis] = side * box[axis]
        return p

    q, r = walls(n), walls(n)
    nq, nr = 150_000, 160_000
    assert -(-n // K.RT) * K.RT > K.RES_MAX_ROWS
    before = [k.launches for k in K.KERNELS]
    d, i = K.knn(q, r, nr, nq)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(K.KERNELS, before)] == [1, 0, 0]
    q4 = K._pad_rows(torch.cat([q, q.new_ones(n, 1)], 1), -(-n // K.QT) * K.QT)
    bias = torch.where(torch.arange(n, device=card) < nr, -0.5 * (r * r).sum(1),
                       torch.full((n,), K.NEG, device=card))
    r4 = K._pad_rows(torch.cat([r, bias[:, None]], 1), -(-n // K.RT) * K.RT)
    r4[n:, 3] = K.NEG
    args = (q4, r4, K._tile_boxes(r4[:, :3], K.RT), None, None, nq, nr, K.RT)
    s_k, i_k = K.dense_kernel(*args)
    s_p, i_p = K.dense_plain(*args)
    _assert_same_nn(q4, r4, s_k, i_k, s_p, i_p, nq)
    assert torch.equal(i[:nq], i_k[:nq])
    assert bool((i_k[:nq] < nr).all())


@pytest.mark.cuda
def test_recover_depth_gradient_on_the_card_matches_the_cpu(card):
    """gradient_experiments' loss and its gradient with respect to the
    corrupted depths on a 2-frame 64x96 window, card against CPU: the loss
    to rtol 1e-4, the gradient to 2e-3 of its largest entry but at the
    pixels of the map rows that differ between the devices: a row whose KNN
    picks differ (float32 ties, held to fp32_distance_bound) or whose fused
    values differ (a projection rounding to another pixel) feeds another
    residual back to the two pixels it was made from, at most."""
    from e2eslam_tpu_torch.apps.gradient_experiments import make_loss_fn
    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.data.synthetic import SyntheticDataset
    from e2eslam_tpu_torch.engine.refine import PairBatch
    from e2eslam_tpu_torch.slam.slam import PointFusion
    from e2eslam_tpu_torch.utils.corruption import corrupt_rgbd

    H, W = 64, 96
    cfg = load_yaml(default_config_path())
    colors, depths, Kin, poses, _ = SyntheticDataset(seqlen=2, height=H, width=W, dilation=2,
                                                     total_frames=12)[0]
    host = [torch.from_numpy(np.array(x, np.float32)) for x in (colors / 255.0, depths, Kin,
                                                                poses)]
    nc, nd = corrupt_rgbd(cfg, torch.Generator().manual_seed(0), host[0][None], host[1][None])
    res = {}
    for dev in (card, torch.device("cpu")):
        pair = PairBatch(*(x.to(dev) for x in host))
        loss_fn = make_loss_fn(cfg, pair, nc[0].to(dev), nd[0].to(dev))
        v = {"depths": nd[0].to(dev).clone().requires_grad_(True)}
        loss, _ = loss_fn(v)
        loss.backward()
        slam = PointFusion(odom="gt")
        with torch.no_grad():
            gt_map, _ = slam(pair.colors, pair.gt_depths, pair.intrinsics, pair.poses,
                             capacity=2 * H * W)
            noisy, _ = slam(nc[0].to(dev), nd[0].to(dev), pair.intrinsics, pair.poses,
                            capacity=2 * H * W)
        _, nn = K.knn(noisy.points, gt_map.points, gt_map.count, noisy.count)
        res[dev.type] = (float(loss.detach()), v["depths"].grad.cpu(), noisy.data.cpu(),
                         noisy.count, nn[:noisy.count].long().cpu(), gt_map.points.cpu())
    (l_g, g, rows_g, n, nn_g, ref), (l_c, w, rows_c, n_c, nn_c, _) = res["cuda"], res["cpu"]
    np.testing.assert_allclose(l_g, l_c, rtol=1e-4)
    assert n == n_c
    moved = (rows_g[:n] - rows_c[:n]).abs().amax(dim=1) > 1e-6
    picks = (nn_g != nn_c) & ~moved
    q, r = rows_c[:n, :3].double(), ref.double()
    gap = (((q - r[nn_g]) ** 2).sum(1) - ((q - r[nn_c]) ** 2).sum(1)).abs()[picks]
    bound = torch.maximum(K.fp32_distance_bound(q[picks], r[nn_g[picks]]),
                          K.fp32_distance_bound(q[picks], r[nn_c[picks]]))
    assert bool((gap <= bound).all())
    differing = int((moved | picks).sum())
    assert differing <= n // 100, differing
    assert float(w.abs().max()) > 0
    off = (g - w).abs() > 2e-3 * float(w.abs().max())
    assert int(off.sum()) <= 2 * differing, (int(off.sum()), differing)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dense", "cand", "resident"])
def test_kernels_read_their_counts_on_the_card(card, kernel):
    """Each kernel given its valid counts as device tensors (read by the
    kernel, for a launch inside a CUDA graph) returns the bits of the same
    call given them as host ints."""
    args = _args(card, kernel, seeded=True)
    kern = getattr(K, f"{kernel}_kernel")
    nq, nr = args[-3], args[-2]  # (..., nq, nr, tile) for every kernel
    dev_args = list(args)
    dev_args[-3] = torch.full((), nq, dtype=torch.int64, device=card)
    dev_args[-2] = torch.full((), nr, dtype=torch.int64, device=card)
    s_h, i_h = kern(*args)
    s_d, i_d = kern(*dev_args)
    assert torch.equal(s_h[:nq], s_d[:nq]) and torch.equal(i_h[:nq], i_d[:nq])


def _sequence_runner(program=True, **over):
    """The default config at 64x64 over 6 frames (5 keyframes, so 3 warm
    events), on the card."""
    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    cfg = load_yaml(default_config_path())
    cfg.DATA.height = cfg.DATA.width = 64
    cfg.DEMO.sequence_length = 6
    cfg.DEMO.frame_threshold = 0.01
    cfg.OPTIMIZATION.refinement_steps = 2
    for k, v in over.items():
        sec, flag = k.split(".")
        cfg[sec][flag] = v
    runner = OnlineAdaptation(cfg)
    runner.use_sequence_program = program
    return runner


class _EagerGraph:
    """Stands in for a captured graph: its replay runs the event eagerly."""

    def __init__(self, run):
        self.replay = run


@pytest.mark.cuda
@pytest.mark.parametrize("over", [{}, {"LOSS.chamfer_distance": True},
                                  {"MODEL.fusion_impl": "index", "LOSS.knn_impl": "index",
                                   "MODEL.index_levels": 2, "MODEL.index_level2_period": 2}],
                         ids=["brute", "chamfer", "index"])
def test_captured_event_equals_the_eager_event(card, over):
    """With deterministic algorithms, the program's warm events replayed
    from one CUDA graph give what the same events run eagerly give: the
    same metrics, poses and map."""
    runs = []
    for graph in (True, False):
        runner = _sequence_runner(**over)
        engine = runner.engine
        if not graph:
            def eager(seq, K_, pair_i, ev_i, ms, carry, out, est, info, _e=engine):
                return _EagerGraph(lambda: _e._sequence_event(seq, K_, pair_i, ev_i, ms, carry,
                                                              out, est, fuse_prev=False))

            engine._capture_event = eager
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            runs.append(runner.run(verbose=False))
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
    a, b = runs
    assert a["sequence_program"] and a["graphs"] == 1 and b["graphs"] == 0
    assert a["keyframes"] == b["keyframes"] and len(a["keyframes"]) >= 4
    for ma, mb in zip(a["metrics"], b["metrics"]):
        assert ma.keys() == mb.keys()
        for key in ma:
            np.testing.assert_allclose(ma[key], mb[key], rtol=1e-5, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(a["est_poses"], b["est_poses"], atol=1e-6)
    assert a["map_points"] == b["map_points"]
    n = a["map_points"]
    torch.testing.assert_close(a["map"].data[:n], b["map"].data[:n], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("over", [{}, {"MODEL.compact_period": 2},
                                  {"MODEL.compact_period": 2, "MODEL.compact_mode": "projective"},
                                  {"VIZ.log_gradients": True, "DEBUG.plot": True,
                                   "DEBUG.plot_path": None}],
                         ids=["plain", "compact", "compact_projective", "observed"])
def test_replays_make_no_host_synchronisation(card, over):
    """The replay loop (each event's pinned index copies and its graph
    replay) and the compaction passes between replays raise nothing under
    set_sync_debug_mode("error"); the run reads the card only after its
    last event. Observed, every event carries its gradient norms and
    debug images."""
    runner = _sequence_runner(**over)
    runner.engine.replay_sync_mode = "error"
    result = runner.run(verbose=False)
    assert result["sequence_program"] and result["graphs"] == 1
    assert len(result["keyframes"]) >= 4
    assert all(np.isfinite(m["abs_rel"]) for m in result["metrics"])
    if "MODEL.compact_period" in over:
        assert [c["keyframe"] for c in result["compactions"]] == [1, 3]
    if "DEBUG.plot" in over:
        assert all(np.isfinite(list(m["grad_norms"].values())).all()
                   and m["debug_images"]["depth"].shape == (64, 64) for m in result["metrics"])



@pytest.mark.cuda
@pytest.mark.parametrize("form", ["torch_capturable_adam", "torch_default_adam", "port_sgd"])
def test_optimizers_under_device_schedule_match_optax(card, form):
    """torch's Adam in its ``capturable`` form under ``DeviceSchedule`` (the
    programs' per-tensor Adam and tensor learning rate) and in its default
    form (the loop's), and the port's SGD under ``DeviceSchedule``, on the
    card: 30 updates across a StepLR decay against the float64
    transcription of optax's formula (``chip_smoke.optax_reference``,
    itself held against optax by tests/test_torch_optim.py) at
    tests/test_torch_optim.py's 1e-6. The port's SGD also equals its
    host-scheduled run to the bit."""
    from chip_smoke import OPTAX_TOL, _optimizer_run, optax_inputs, optax_reference
    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.engine.optim import SGD

    cfg = load_yaml(default_config_path())
    cfg.OPTIMIZATION.update({"learning_rate": 1e-2, "schedular": "StepLR",
                             "schedular_step_size": 10, "schedular_gamma": 0.5})
    init, grads = optax_inputs()
    make = {"torch_capturable_adam": lambda ps: torch.optim.Adam(ps, lr=1e-2, capturable=True),
            "torch_default_adam": lambda ps: torch.optim.Adam(ps, lr=1e-2),
            "port_sgd": lambda ps: SGD(ps, lr=1e-2, foreach=True)}[form]
    want = optax_reference("sgd" if form == "port_sgd" else "adam", init, grads,
                           [1e-2 * 0.5 ** (t // 10) for t in range(len(grads))])
    got = _optimizer_run(make, init, grads, cfg, device_schedule=form != "torch_default_adam")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=OPTAX_TOL,
                                   atol=OPTAX_TOL * np.abs(want[k]).max(), err_msg=k)
    if form == "port_sgd":
        host = _optimizer_run(make, init, grads, cfg, device_schedule=False)
        for k in want:
            assert np.array_equal(host[k], got[k]), k

def _batched_program(graph: bool):
    """Two ragged 64x64 sequences through ``ParallelAdaptation.run(dispatch=
    "whole")`` with deterministic algorithms; without ``graph`` the warm
    events run eagerly where they would replay. The replays run under
    ``set_sync_debug_mode("error")``."""
    from e2eslam_tpu_torch.apps.profile_adaptation import make_sequences
    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.models.depth_net import make_depth_model
    from e2eslam_tpu_torch.parallel.adaptation import ParallelAdaptation

    cfg = load_yaml(default_config_path())
    cfg.DATA.height = cfg.DATA.width = 64
    cfg.DEMO.frame_threshold = 0.01
    cfg.OPTIMIZATION.refinement_steps = 2
    seqs = make_sequences(2, 7, 64, 64)
    c, d, K_, p = seqs
    c[1, 4:], d[1, 4:], p[1, 4:] = c[1, 3], d[1, 3], p[1, 3]  # ragged
    par = ParallelAdaptation(cfg, make_depth_model(cfg), map_capacity=7 * 64 * 64, n_seq=2)
    par.par.engines[0].replay_sync_mode = "error"
    if not graph:
        def eager(state, seq, ins, maps, carry, out, est, info):
            return _EagerGraph(lambda: par._event(state, seq, ins, maps, carry, out, est,
                                                  fuse_prev=False))

        par._capture_event = eager
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return par.run(par.init_state(), (c, d, K_, p), threshold=0.01, dispatch="whole")
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
def test_batched_program_replays_equal_its_eager_events(card):
    """The program over two ragged sequences: one graph captured, its
    replays free of host synchronisation, and every sequence's metrics,
    poses and map what the same events run eagerly give."""
    a, b = _batched_program(True), _batched_program(False)
    assert a["dispatch"] == "whole" and a["graphs"] == 1 and b["graphs"] == 0
    kf = [r["num_keyframes"] for r in a["per_sequence"]]
    assert kf[1] < kf[0] and a["num_events"] >= 4
    for x, y in zip(a["per_sequence"], b["per_sequence"]):
        assert x["keyframes"] == y["keyframes"]
        for mx, my in zip(x["metrics"], y["metrics"]):
            for key in mx:
                np.testing.assert_allclose(mx[key], my[key], rtol=1e-5, atol=1e-7,
                                           err_msg=key)
        np.testing.assert_allclose(x["est_poses"], y["est_poses"], atol=1e-6)
        assert x["map_points"] == y["map_points"]


@pytest.mark.cuda
def test_timestamp_kernel_writes_one_row_per_replay(card):
    """The program's mark (``utils/tracing.py::stamp``) captured into a CUDA
    graph between device work: every replay writes the row its device-side
    event index names, monotone within the row and after the row before."""
    from e2eslam_tpu_torch.utils import tracing

    E, K = 5, 4
    stamps = torch.zeros(E, K, dtype=torch.int64, device=card)
    row = torch.zeros(1, dtype=torch.int64, device=card)
    x = torch.randn(1024, 1024, device=card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the eager path loads and launches it first
        tracing.stamp(stamps, row, 0)
        y = x @ x
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert int(stamps[0, 0]) > 0
    stamps.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(K):
            tracing.stamp(stamps, row, k)
            y = (y @ x).tanh()
    for e in range(E):
        row.fill_(e)
        graph.replay()
    torch.cuda.synchronize()
    st = stamps.cpu()
    assert (st > 0).all()
    assert (st[:, 1:] > st[:, :-1]).all()
    assert (st[1:, 0] > st[:-1, -1]).all()


@pytest.mark.cuda
def test_traced_program_stamps_agree_with_the_cards_clocks(card, monkeypatch):
    """The program on the card, traced (under the profiler) and not: the
    untraced run launches no mark; each replayed event of the traced run
    holds the P phase times of the program it traced (4 + 8R: the
    single-sequence step's ``tracing.NETWORK_STEP_PHASES``, three of them
    marked from the backward's hooks) whose sum, its first to last mark, agrees
    within 1% or 50 us with CUDA events around its replay (each replay
    queued behind a sleep kernel, so that the events bracket the graph's
    work and not the host's launch; the graph's first replay, which also
    uploads it, left out), and the profiler's trace holds every mark's
    kernel. (The profiler's own device timestamps are not held to the
    marks: measured on an H100 they ran up to 3.4% fast or slow until the
    profiler re-synchronised its clock within a session, then agreed
    within about 1 us; PERF.md §6.)"""
    from e2eslam_tpu_torch.utils import tracing

    def refuse(*a, **k):
        raise AssertionError("a mark while no profiler records")

    with monkeypatch.context() as m:
        m.setattr(tracing, "stamp", refuse)
        plain = _sequence_runner().run(verbose=False)
    assert plain["graphs"] == 1 and plain["trace"] is None
    timed, replay = [], torch.cuda.CUDAGraph.replay

    def timed_replay(graph):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)  # a few ms: the launch lands behind it
        a.record()
        replay(graph)
        b.record()
        timed.append((a, b))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", timed_replay)
    with torch.profiler.profile(activities=acts) as prof:
        result = _sequence_runner().run(verbose=False)
    trace = result["trace"]
    E = len(result["keyframes"])
    assert trace["replayed"] == [e >= 1 for e in range(E)] and len(timed) == E - 1
    phases = tracing.phase_names(2, tracing.NETWORK_STEP_PHASES)
    P = len(phases)
    assert trace["phases"] == phases and P == 4 + 8 * 2
    phase_ms = np.asarray(trace["event_phase_ms"])
    assert phase_ms.shape == (E, P) and (phase_ms >= 0).all()
    stamped = phase_ms.sum(axis=1)[2:]
    events = np.asarray([a.elapsed_time(b) for a, b in timed[1:]])
    assert (np.abs(events - stamped) <= np.maximum(0.05, 0.01 * stamped)).all(), (events, stamped)
    marks = [n for _, _, n in tracing.device_intervals(prof.events())
             if n == tracing.TIMESTAMP_KERNEL]
    assert len(marks) == E * (P + 1)


def _unit_config(kind: str, frames: int = 12):
    """One of the benchmark's configurations as the port's own config
    builds it, cut to ``frames`` frames at full size: ``default``
    (configs/config.yaml), ``flagship`` (``profile_adaptation.flagship_config``)
    or ``monodepth2-r50`` (default with monodepth2's ResNet-50)."""
    from e2eslam_tpu_torch.apps.profile_adaptation import flagship_config
    from e2eslam_tpu_torch.config import default_config_path, load_yaml

    cfg = load_yaml(default_config_path())
    if kind == "flagship":
        cfg = flagship_config(cfg)
    elif kind == "monodepth2-r50":
        cfg.MODEL.depth_network, cfg.MODEL.num_layers = "monodepth2", 50
    cfg.DEMO.sequence_length = frames
    cfg.DEBUG.print_metrics = False
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["default", "flagship"])
def test_back_to_back_units_reuse_the_process_caches(card, kind):
    """Two 12-frame units of one configuration back to back in one process,
    with deterministic algorithms: the same metrics, poses and map to the
    bit, and the second unit's program allocates and frees nothing on the
    card (its side and capture streams and its graph pool are the
    process's, and no capture empties the allocator's cache); each runs
    event 0 alone eagerly."""
    import gc

    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    units = []
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for _ in range(2):
            r = OnlineAdaptation(_unit_config(kind)).run(verbose=False)
            n = r["map_points"]
            units.append({"metrics": r["metrics"], "est_poses": r["est_poses"],
                          "keyframes": r["keyframes"], "graphs": r["graphs"],
                          "counts": r["counts"], "map": r["map"].data[:n].cpu()})
            del r
            gc.collect()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    a, b = units
    assert a["graphs"] == b["graphs"] == 1 and len(a["keyframes"]) >= 3
    assert a["keyframes"] == b["keyframes"] and a["metrics"] == b["metrics"]
    assert np.array_equal(a["est_poses"], b["est_poses"])
    assert a["map"].shape == b["map"].shape and torch.equal(a["map"], b["map"])
    assert a["counts"]["eager_events"] == b["counts"]["eager_events"] == 1
    assert b["counts"]["device_allocs"] == 0 and b["counts"]["device_frees"] == 0, b["counts"]


_FRESH_UNIT = """
import json, sys
sys.path.insert(0, "tests")
import numpy as np
import torch
from test_torch_cuda import _unit_config
from e2eslam_tpu_torch.device import set_full_fp32

kind = sys.argv[1]
set_full_fp32()
if kind == "flagship-fleet":
    from e2eslam_tpu_torch.apps.profile_adaptation import make_sequences
    from e2eslam_tpu_torch.models.depth_net import make_depth_model
    from e2eslam_tpu_torch.parallel.adaptation import ParallelAdaptation

    cfg = _unit_config("flagship")
    L, H, W = 12, int(cfg.DATA.height), int(cfg.DATA.width)
    par = ParallelAdaptation(cfg, make_depth_model(cfg), map_capacity=L * H * W, n_seq=2)
    r = par.run(par.init_state(), make_sequences(2, L, H, W),
                threshold=float(cfg.DEMO.frame_threshold), dispatch="whole")
    events, abs_rel = r["num_events"], [a for s in r["per_sequence"] for a in s["per_pair_abs_rel"]]
else:
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    r = OnlineAdaptation(_unit_config(kind)).run(verbose=False)
    events, abs_rel = r["num_keyframes"], [m["abs_rel"] for m in r["metrics"]]
print(json.dumps({"graphs": r["graphs"], "counts": r["counts"], "events": events,
                  "finite": bool(np.isfinite(abs_rel).all())}))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["default", "flagship", "monodepth2-r50", "flagship-fleet"])
def test_a_fresh_process_captures_at_event_1(card, kind):
    """One 12-frame unit of each configuration (and the flagship through the
    fleet's program, B = 2) as the first work of a fresh process: nothing
    warmed but event 0, the capture at event 1 succeeds, and every
    keyframe's abs_rel is finite."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _FRESH_UNIT, kind], cwd=root,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["events"] >= 3 and got["graphs"] == 1 and got["finite"], got
    assert got["counts"]["eager_events"] == 1, got

