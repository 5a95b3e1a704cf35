"""Parity of the gradient-flow experiment (``apps/gradient_experiments.py``)
with the JAX package's at 64x64: the JAX ``corrupt_rgbd``'s output is fed to
both sides, the clean window's map is reconstructed on each, and the loss
(KNN + colour point losses of the corrupted sequence's PointFusion map) and
its gradient with respect to the corrupted colours and depths are held to
the JAX package's ``jax.grad`` -- rtol 1e-4 for the loss terms, 2e-3 of
each gradient's largest entry (tests/test_torch_pft_step.py). Where the two
packages' KNN picks for a row of the corrupted map differ, the picks are
float32 ties (their float64 distances differ by less than
``ops/knn.py::fp32_distance_bound``) and the residual that row feeds back
differs: at most one pixel per such row may then miss the gradient
tolerance (three rows, three pixels at this size). Then five steps of the
port's experiment from the same inputs lower the loss.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2eslam_tpu.config import default_config_path as jax_default_path
from e2eslam_tpu.config import load_yaml as jax_load_yaml
from e2eslam_tpu.data.pipeline import load_batch, make_dataset
from e2eslam_tpu.losses.points import color_points_loss, knn_points_loss
from e2eslam_tpu.slam.slam import PointFusion as JaxPointFusion
from e2eslam_tpu.utils.corruption import corrupt_rgbd
from e2eslam_tpu_torch.apps.gradient_experiments import make_loss_fn, recover_image
from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.engine.refine import PairBatch
from e2eslam_tpu_torch.ops.knn import fp32_distance_bound, knn
from e2eslam_tpu_torch.slam.slam import PointFusion

H = W = 64


def _cfg(load, path):
    cfg = load(path)
    cfg.DATA.name = "synthetic"
    cfg.DATA.height, cfg.DATA.width = H, W
    cfg.DATA.start, cfg.DATA.dilation, cfg.DATA.stride = 0, 2, 2
    cfg.DATA.frames = [0, -1]
    cfg.OPTIMIZATION.learning_rate = 1e-2
    cfg.SETTINGS.device = "cpu"
    return cfg


@pytest.fixture(scope="module")
def case():
    cfg = _cfg(jax_load_yaml, jax_default_path())
    ds = make_dataset(cfg, sequence_length=2)
    colors, depths, K, poses, _ = load_batch(ds, [0])
    colors, depths, K, poses = colors[0], depths[0], K[0], poses[0]
    nc, nd = corrupt_rgbd(cfg, jax.random.key(0), colors[None], depths[None])
    nc, nd = np.asarray(nc[0]), np.asarray(nd[0])
    slam = JaxPointFusion(odom="gt", sigma=float(cfg.MODEL.sigma))
    cap = 2 * H * W
    gt_map = jax.lax.stop_gradient(slam(colors, depths, K, poses, capacity=cap)[0])

    def loss_fn(variables):
        noisy_map, _ = slam(variables["colors"], variables["depths"], K, poses, capacity=cap)
        knn_l, idx = knn_points_loss(gt_map.points, noisy_map.points, n_gt=gt_map.count,
                                     n_query=noisy_map.count)
        color_l = color_points_loss(gt_map.colors, noisy_map.colors, idx,
                                    n_query=noisy_map.count)
        return knn_l + color_l, (knn_l, color_l)

    (loss, (knn_l, color_l)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        {"colors": jnp.asarray(nc), "depths": jnp.asarray(nd)})
    noisy_map, _ = slam(jnp.asarray(nc), jnp.asarray(nd), K, poses, capacity=cap)
    _, idx = knn_points_loss(gt_map.points, noisy_map.points, n_gt=gt_map.count,
                             n_query=noisy_map.count)
    want = dict(loss=float(loss), knn=float(knn_l), color=float(color_l),
                grads={k: np.asarray(v) for k, v in grads.items()},
                nn=np.asarray(idx)[:int(noisy_map.count)])
    pcfg = _cfg(load_yaml, default_config_path())
    pair = PairBatch(*(torch.from_numpy(np.array(x)) for x in (colors, depths, K, poses)))
    return dict(cfg=pcfg, pair=pair, noisy=(torch.from_numpy(np.array(nc)), torch.from_numpy(np.array(nd))),
                want=want)


def test_loss_and_gradients_match_jax_grad(case):
    nc, nd = case["noisy"]
    loss_fn = make_loss_fn(case["cfg"], case["pair"], nc, nd)
    variables = {"colors": nc.clone().requires_grad_(True),
                 "depths": nd.clone().requires_grad_(True)}
    loss, aux = loss_fn(variables)
    loss.backward()
    want = case["want"]
    # The rows whose KNN picks differ: float32 ties.
    slam = PointFusion(odom="gt", sigma=float(case["cfg"].MODEL.sigma))
    pair = case["pair"]
    with torch.no_grad():
        gt_map, _ = slam(pair.colors, pair.gt_depths, pair.intrinsics, pair.poses,
                         capacity=2 * H * W)
        noisy_map, _ = slam(nc, nd, pair.intrinsics, pair.poses, capacity=2 * H * W)
    n = noisy_map.count
    _, nn = knn(noisy_map.points, gt_map.points, gt_map.count, n)
    nn = nn[:n].long()
    jnn = torch.from_numpy(np.array(want["nn"])).long()
    ties = torch.nonzero(nn != jnn).ravel()
    q, r = noisy_map.points[:n].double(), gt_map.points.double()
    gap = (((q - r[nn]) ** 2).sum(1) - ((q - r[jnn]) ** 2).sum(1)).abs()[ties]
    bound = torch.maximum(fp32_distance_bound(q[ties], r[nn[ties]]),
                          fp32_distance_bound(q[ties], r[jnn[ties]]))
    assert bool((gap <= bound).all()) and len(ties) <= n // 1000, (ties, gap, bound)
    np.testing.assert_allclose(float(loss.detach()), want["loss"], rtol=1e-4)
    np.testing.assert_allclose(float(aux["knn"]), want["knn"], rtol=1e-4)
    np.testing.assert_allclose(float(aux["color"]), want["color"], rtol=1e-4)
    for k, v in variables.items():
        w = want["grads"][k]
        assert np.abs(w).max() > 0, k
        # The gradient reaches both frames through the fused and appended rows.
        assert float(v.grad[0].abs().max()) > 0 and float(v.grad[1].abs().max()) > 0, k
        off = np.abs(v.grad.numpy() - w) > 2e-3 * float(np.abs(w).max())
        assert int(off.any(axis=-1).sum()) <= len(ties), (k, int(off.sum()), len(ties))


def test_five_steps_lower_the_loss(case):
    out = recover_image(case["cfg"], num_steps=5, verbose=False, noisy=case["noisy"])
    np.testing.assert_allclose(out["initial_loss"], case["want"]["loss"], rtol=1e-4)
    assert out["final_loss"] < out["initial_loss"]
    assert all(b < a for a, b in zip(out["history"], out["history"][1:])), out["history"]
    assert set(out["recovered"]) == {"colors", "depths"}


@pytest.mark.parametrize("fusion", ["scatter", "scatter window", "index"])
def test_fusion_under_autograd_equals_in_place(case, fusion):
    """``PointFusion.__call__`` with depths and colours that require grad
    builds the same map as the in-place fusion outside autograd (scatter,
    scatter within an active window, index fusion, whose out-of-place
    writes keep each slot's winner), and its gradient reaches both frames."""
    nc, nd = case["noisy"]
    pair = case["pair"]
    slam = PointFusion(odom="gt", fusion_impl=fusion.split()[0],
                       active_window=3000 if fusion.endswith("window") else None)
    with torch.no_grad():
        want, _ = slam(nc, nd, pair.intrinsics, pair.poses, capacity=2 * H * W)
    c, d = nc.clone().requires_grad_(True), nd.clone().requires_grad_(True)
    got, _ = slam(c, d, pair.intrinsics, pair.poses, capacity=2 * H * W)
    assert got.data.requires_grad and got.count == want.count
    assert torch.equal(got.data.detach(), want.data)
    if fusion == "index":
        assert torch.equal(got.index_image, want.index_image)
    (got.points[:got.count].sum() + got.colors[:got.count].sum()).backward()
    for g in (c.grad, d.grad):
        assert bool(torch.isfinite(g).all()) and float(g[0].abs().max()) > 0
        assert float(g[1].abs().max()) > 0
