"""Parity of the port's core geometry with ``e2eslam_tpu/core``.

Tolerance: float32 (1e-5 relative / 1e-5 absolute on unit-scale values;
the two sides round products in different orders). Projected pixel
coordinates and grid gradients carry the image's pixel scale (W/2 per unit
of the [-1, 1] grid), hence 1e-4 and 1e-3 absolute there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2eslam_tpu.core import camera as jcam
from e2eslam_tpu.core import depth as jdepth
from e2eslam_tpu.core import projection as jproj
from e2eslam_tpu.core import sampling as jsamp
from e2eslam_tpu.core import se3 as jse3
from e2eslam_tpu_torch.core import camera, depth, projection, sampling, se3

TOL = dict(rtol=1e-5, atol=1e-5)


def _poses(rng, n):
    out = []
    for _ in range(n):
        w = rng.normal(size=3) * 0.3
        th = np.linalg.norm(w)
        k = w / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        T = np.eye(4)
        T[:3, :3] = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        T[:3, 3] = rng.normal(size=3)
        out.append(T)
    return np.stack(out).astype(np.float32)


def _K(h, w):
    f = 0.75 * w
    return np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                    np.float32)


def test_se3_inverse_transform_center():
    rng = np.random.default_rng(0)
    T = _poses(rng, 5)
    pts = rng.normal(size=(5, 40, 3)).astype(np.float32)
    np.testing.assert_allclose(se3.se3_inverse(torch.from_numpy(T)).numpy(),
                               np.asarray(jse3.se3_inverse(jnp.asarray(T))), **TOL)
    np.testing.assert_allclose(
        se3.transform_points(torch.from_numpy(T), torch.from_numpy(pts)).numpy(),
        np.asarray(jse3.transform_points(jnp.asarray(T), jnp.asarray(pts))), **TOL)
    np.testing.assert_allclose(se3.camera_center(torch.from_numpy(T)).numpy(),
                               np.asarray(jse3.camera_center(jnp.asarray(T))), **TOL)


def test_intrinsics_and_depth_conversions():
    K = np.stack([_K(64, 96), _K(256, 320)])
    np.testing.assert_allclose(camera.inverse_intrinsics(torch.from_numpy(K)).numpy(),
                               np.asarray(jcam.inverse_intrinsics(jnp.asarray(K))), **TOL)
    d = np.random.default_rng(1).uniform(0.01, 10.0, (2, 8, 8, 1)).astype(np.float32)
    np.testing.assert_allclose(depth.indoor_disp_to_depth(torch.from_numpy(d)).numpy(),
                               np.asarray(jdepth.indoor_disp_to_depth(jnp.asarray(d))),
                               **TOL)
    s = d / 10.0
    np.testing.assert_allclose(depth.disp_to_depth(torch.from_numpy(s), 0.1, 80.0).numpy(),
                               np.asarray(jdepth.disp_to_depth(jnp.asarray(s), 0.1, 80.0)),
                               **TOL)


@pytest.mark.parametrize("scale", [0.1, 1.0])
def test_backproject_project(scale):
    rng = np.random.default_rng(2)
    H, W = 24, 32
    dep = rng.uniform(0.5, 4.0, (2, H, W, 1)).astype(np.float32)
    K = np.stack([_K(H, W)] * 2)
    T = _poses(rng, 2)
    T[:, :3, 3] *= scale  # 1.0: many points leave the frame (valid = 0)
    Kinv = camera.inverse_intrinsics(torch.from_numpy(K))
    pts = projection.backproject(torch.from_numpy(dep), Kinv)
    jpts = jproj.backproject(jnp.asarray(dep), jcam.inverse_intrinsics(jnp.asarray(K)))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), **TOL)
    out = projection.project(pts, torch.from_numpy(K), torch.from_numpy(T))
    jout = jproj.project(jpts, jnp.asarray(K), jnp.asarray(T))
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_values_and_grads(padding_mode, align_corners):
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(2, 12, 16, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 9, 11, 2)).astype(np.float32)
    ti = torch.from_numpy(img).requires_grad_(True)
    tg = torch.from_numpy(grid).requires_grad_(True)
    out = sampling.grid_sample(ti, tg, padding_mode=padding_mode,
                               align_corners=align_corners)
    wts = rng.normal(size=out.shape).astype(np.float32)
    (out * torch.from_numpy(wts)).sum().backward()

    def f(i, g):
        o = jsamp.grid_sample(i, g, padding_mode=padding_mode, align_corners=align_corners)
        return jnp.sum(o * wts), o

    (_, jo), (gi, gg) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(img), jnp.asarray(grid))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(gg), rtol=1e-4, atol=1e-3)
