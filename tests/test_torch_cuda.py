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
