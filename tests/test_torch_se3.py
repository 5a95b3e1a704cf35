"""Parity of the port's SE(3) maps with ``e2eslam_tpu/core/se3.py``.

Tolerances: float32 values to 1e-5 absolute (one rounding of a few chained
products); gradients to 1e-4 of their largest entry. At theta = pi the
logarithm's sign is a free choice (both signs are valid logs), and the two
packages' last-bit differences in the trace may pick different signs, so
there the rotation part is held up to that sign. Every log is held by its
exponential back to the pose within ``tests/test_se3.py``'s bound at pi,
5e-4 (float32 loses the axis there).
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2eslam_tpu.core import se3 as jse3
from e2eslam_tpu_torch.core import se3

# theta: 0, below the series switch, both sides of it (1e-4 +- eps), a
# generic angle, the near-pi branch, pi.
THETAS = [0.0, 1e-6, 1e-4 - 1e-6, 1e-4 + 1e-6, 1.0, math.pi - 1e-3, math.pi]


def _twist(theta, seed=0):
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    return np.concatenate([rng.normal(size=3) * 0.3, theta * axis]).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("theta", THETAS)
def test_exp_matches_jax(theta):
    xi = np.stack([_twist(theta, s) for s in range(3)])
    np.testing.assert_allclose(se3.se3_exp(_t(xi)).numpy(),
                               np.asarray(jse3.se3_exp(jnp.asarray(xi))), atol=1e-5, rtol=0)


@pytest.mark.parametrize("theta", THETAS)
def test_log_matches_jax(theta):
    """Both logs of the same poses (the JAX package's exponentials)."""
    xi = np.stack([_twist(theta, s) for s in range(3)])
    T = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    got = se3.se3_log(_t(T)).numpy()
    want = np.asarray(jse3.se3_log(jnp.asarray(T)))
    for g, w in zip(got, want):
        if theta < math.pi or np.allclose(g[3:], w[3:], atol=1e-5):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        else:  # the other sign's log
            np.testing.assert_allclose(g[3:], -w[3:], atol=1e-5, rtol=0)
    # Back to the pose within tests/test_se3.py's bound at pi (5e-4).
    np.testing.assert_allclose(se3.se3_exp(_t(got)).numpy(), T, atol=5e-4, rtol=0)


def test_poses_to_transforms_matches_jax():
    rng = np.random.default_rng(1)
    xi = (rng.normal(size=(2, 5, 6)) * 0.5).astype(np.float32)
    poses = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    for p in (poses, poses[0]):  # [B, L] and [L]
        got = se3.poses_to_transforms(_t(p)).numpy()
        np.testing.assert_allclose(got, np.asarray(jse3.poses_to_transforms(jnp.asarray(p))),
                                   atol=1e-5, rtol=0)
        assert np.array_equal(got.reshape(-1, 5, 4, 4)[:, 0],
                              np.broadcast_to(np.eye(4), (got.reshape(-1, 5, 4, 4).shape[0], 4, 4)))


@pytest.mark.parametrize("case", ["exp at identity", "log at identity", "log of exp(0)",
                                  "log generic", "log near pi"])
def test_gradients_finite_and_match_jax(case):
    """``tests/test_se3.py:63-137``'s points: the gradients are finite and
    equal to ``jax.grad``'s."""
    if case == "exp at identity":
        x = np.zeros(6, np.float32)
        tf = lambda a: se3.se3_exp(a).sum()  # noqa: E731
        jf = lambda a: jnp.sum(jse3.se3_exp(a))  # noqa: E731
    else:
        xi = {"log at identity": None, "log of exp(0)": np.zeros(6),
              "log generic": np.array([0.1, -0.2, 0.3, 0.4, 0.5, -0.6]),
              "log near pi": np.array([0.0, 0.0, 0.0, 3.13, 0.05, 0.0])}[case]
        x = (np.eye(4, dtype=np.float32) if xi is None
             else np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float32))))
        tf = lambda a: (se3.se3_log(a) ** 2).sum()  # noqa: E731
        jf = lambda a: jnp.sum(jse3.se3_log(a) ** 2)  # noqa: E731
    a = _t(x).requires_grad_(True)
    tf(a).backward()
    got = a.grad.numpy()
    want = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, np.abs(want).max()), rtol=0)
