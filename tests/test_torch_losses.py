"""Parity of the port's losses with ``e2eslam_tpu/losses`` and the engine's
median scaling.

Tolerances: float32 elementwise maps and means, 1e-5 relative/absolute;
the 3D point loss sums ~1e3 squared residuals, 1e-5 relative. Gradients
of the point loss: 1e-5 relative, 1e-6 absolute.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2eslam_tpu.losses.metrics import depth_metrics as jax_metrics
from e2eslam_tpu.losses.photometric import photometric_loss as jax_photo
from e2eslam_tpu.losses.photometric import ssim as jax_ssim
from e2eslam_tpu.losses.points import knn_points_loss as jax_points
from e2eslam_tpu_torch.engine.refine import _median, masked_point_loss
from e2eslam_tpu_torch.losses.metrics import depth_metrics
from e2eslam_tpu_torch.losses.photometric import photometric_loss, ssim
from e2eslam_tpu_torch.losses.points import knn_points_loss

TOL = dict(rtol=1e-5, atol=1e-5)


def _images(seed, shape=(2, 20, 24, 3)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=shape).astype(np.float32)
    y = np.clip(x + rng.normal(size=shape) * 0.1, 0, 1).astype(np.float32)
    return x, y


def test_ssim_and_photometric_maps():
    x, y = _images(0)
    np.testing.assert_allclose(ssim(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               np.asarray(jax_ssim(jnp.asarray(x), jnp.asarray(y))), **TOL)
    got = photometric_loss(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (2, 20, 24, 1)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_photo(jnp.asarray(x), jnp.asarray(y))), **TOL)


def test_photometric_gradient():
    x, y = _images(1)
    t = torch.from_numpy(x).requires_grad_(True)
    photometric_loss(t, torch.from_numpy(y)).mean().backward()
    g = jax.grad(lambda a: jnp.mean(jax_photo(a, jnp.asarray(y))))(jnp.asarray(x))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("dataset", ["synthetic", "ICL", "TUM"])
def test_depth_metrics(dataset):
    rng = np.random.default_rng(2)
    gt = rng.uniform(0.5, 5.0, (16, 16, 1)).astype(np.float32)
    gt[:3] = 0.0 if dataset == "TUM" else gt[:3]
    pred = (gt * rng.uniform(0.8, 1.3, gt.shape) + 0.01).astype(np.float32)
    a = depth_metrics(dataset, torch.from_numpy(gt), torch.from_numpy(pred))
    b = jax_metrics(dataset, jnp.asarray(gt), jnp.asarray(pred))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(float(a[k]), float(b[k]), **TOL, err_msg=k)


@pytest.mark.parametrize("n", [163840, 7])
def test_median_averages_the_middle_pair(n):
    """``jnp.median`` (and so the online median scaling) averages the two
    middle values of an even count; ``torch.median`` would not."""
    x = np.random.default_rng(3).uniform(0.5, 4.0, n).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_(True)
    m = _median(t)
    np.testing.assert_allclose(float(m.detach()), float(jnp.median(jnp.asarray(x))), rtol=1e-7)
    if n % 2 == 0:
        s = np.sort(x)
        assert float(m.detach()) == float((s[n // 2 - 1] + s[n // 2]) * np.float32(0.5))
        assert float(m.detach()) != float(torch.median(torch.from_numpy(x)))
    m.backward()
    g = jax.grad(lambda a: jnp.median(a))(jnp.asarray(x))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-7)


def test_knn_points_loss_value_and_grads():
    rng = np.random.default_rng(4)
    gt = rng.normal(size=(900, 3)).astype(np.float32)
    q = (gt[rng.integers(0, 900, 500)] + rng.normal(size=(500, 3)) * 0.05).astype(np.float32)
    tg = torch.from_numpy(gt).requires_grad_(True)
    tq = torch.from_numpy(q).requires_grad_(True)
    loss, idx = knn_points_loss(tg, tq, n_gt=800, n_query=450)
    loss.backward()

    def f(g_, q_):
        return jax_points(g_, q_, n_gt=800, n_query=450)

    (jl, jidx), (gg, gq) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(gt), jnp.asarray(q))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_array_equal(idx.numpy()[:450], np.asarray(jidx)[:450])
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gq), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(gg), rtol=1e-5, atol=1e-6)


def test_masked_point_loss_matches_engine_reduction():
    from e2eslam_tpu.engine.refine import _masked_point_loss

    rng = np.random.default_rng(5)
    a, b = rng.normal(size=(2, 300, 3)).astype(np.float32)
    w = (rng.random(300) < 0.7).astype(np.float32)
    got = masked_point_loss(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(w))
    want = _masked_point_loss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    zero = masked_point_loss(torch.from_numpy(a), torch.from_numpy(b), torch.zeros(300))
    assert float(zero) == 0.0
