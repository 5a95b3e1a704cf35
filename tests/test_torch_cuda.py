"""The port's CUDA kernels on one card, against their plain versions.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed; there, skip this directory's conftest (it sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: the kernels score with fused multiply-adds in row order, the
plain versions with a matrix product, so the float32 score
``q.r - 0.5 |r|^2`` rounds differently; distances then agree to a few ulps
of ``|q|^2`` (2e-5 * (1 + |q|^2)). Indices must be equal wherever the
nearest neighbour is unique; where they differ, both picks are equally near.
"""

import numpy as np
import pytest
import torch

from e2eslam_tpu_torch.ops import knn as K


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
    tol = 2e-5 * (1.0 + q2)
    d_k = (q2 - 2 * s_k[:nq].double()).clamp(min=0)
    d_p = (q2 - 2 * s_p[:nq].double()).clamp(min=0)
    assert bool(((d_k - d_p).abs() <= tol).all())
    diff = (i_k[:nq] != i_p[:nq]).nonzero()[:, 0]
    r = r4[:, :3].double()
    via_k = ((q[diff] - r[i_k[:nq][diff].long()]) ** 2).sum(1)
    via_p = ((q[diff] - r[i_p[:nq][diff].long()]) ** 2).sum(1)
    assert bool(((via_k - via_p).abs() <= tol[diff]).all())


def _args(dev, kernel, seeded, nr=60_000):
    """One call's arguments, as the dispatcher builds them."""
    rng = np.random.default_rng(17)
    tile = K.RT if kernel == "dense" else K.ST if kernel == "resident" else K.RT_CAND
    n_tiles = 8 * K.RT // tile
    q, r = _clustered(rng, n_tiles, tile, 3000)
    nq = 2900
    q4 = K._pad_rows(torch.cat([torch.from_numpy(q), torch.ones(3000, 1)], 1),
                     -(-3000 // K.QT) * K.QT).to(dev)
    rt = torch.from_numpy(r).to(dev)
    bias = -0.5 * (rt * rt).sum(1)
    bias[nr:] = K.NEG
    r4 = torch.cat([rt, bias[:, None]], 1).contiguous()
    rbb = K._tile_boxes(r4[:, :3], tile)
    s0 = i0 = None
    if seeded:
        g = torch.Generator(device="cpu").manual_seed(3)
        i0 = torch.randint(0, nr, (q4.shape[0],), generator=g, dtype=torch.int32).to(dev)
        nn0 = rt[i0.long()]
        s0 = ((q4[:, :3] * nn0).sum(1) - 0.5 * (nn0 * nn0).sum(1)).contiguous()
    if kernel == "cand":
        n_qt, n_rt = q4.shape[0] // K.QT, r4.shape[0] // tile
        g = torch.Generator(device="cpu").manual_seed(4)
        cand = torch.stack([torch.randperm(n_rt, generator=g)[:K.MAX_CAND]
                            for _ in range(n_qt)]).to(torch.int32).to(dev)
        cnt = torch.randint(0, K.MAX_CAND + 1, (n_qt,), generator=g,
                            dtype=torch.int32).to(dev)
        return (q4, r4, rbb, s0, i0, cand, cnt, nq, nr, tile)
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


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(card):
    """The dispatcher on the card (kernels) against a float64 brute force,
    cold and warm."""
    rng = np.random.default_rng(7)
    q, r = _clustered(rng, 200, 512, 1024)
    qc, rc = torch.from_numpy(q).to(card), torch.from_numpy(r).to(card)
    want = (torch.cdist(qc.double(), rc.double()) ** 2).min(1).values
    tol = 2e-5 * (1.0 + (qc.double() ** 2).sum(1))
    for init in (None, torch.full((1024,), -1, dtype=torch.int32, device=card)):
        d, i = K.knn(qc, rc, init_idx=init)
        assert bool(((d.double() - want).abs() <= tol).all())
        via = ((qc.double() - rc[i.long()].double()) ** 2).sum(1)
        assert bool(((via - want).abs() <= tol).all())


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
