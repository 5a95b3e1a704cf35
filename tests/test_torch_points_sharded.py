"""The port's 3D losses against a row-sharded map (``losses/points_sharded.py``)
against the JAX package's on the conftest's virtual CPU mesh
(``tests/test_parallel.py:294-355``).

The port runs ``world`` gloo processes (``tests/torch_dist_worker.py``);
the JAX side shards the same map over a ``map`` mesh of ``world`` devices.
Compared on every rank: the frame->map loss (rtol 1e-6) and its indices
(equal), the aux (colour) lookup (equal: a gather by the same indices),
and the bidirectional chamfer's value (rtol 1e-6) and its gradient with
respect to the frame against ``jax.value_and_grad`` (rtol 1e-5, atol
1e-6): the gradient's map->frame half rides the port's two
``autograd.Function``s, so a gradient all-reduced twice (multiplied by
the world size) fails here. The map holds a valid prefix ending mid-shard
and the frame a valid prefix of its points.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2eslam_tpu.losses.points_sharded import (
    chamfer_distance_map_sharded,
    knn_points_loss_map_sharded,
    nn_map_sharded,
)
from e2eslam_tpu.ops.knn_sharded import shard_map_rows
from e2eslam_tpu.parallel.mesh import make_mesh
from e2eslam_tpu_torch.losses.points import chamfer_distance
from e2eslam_tpu_torch.losses.points_sharded import map_to_frame_sum
from e2eslam_tpu_torch.ops.knn_sharded import combine, shard_search
from torch_dist_worker import run_world


def _inputs(world):
    rng = np.random.default_rng(11 + world)
    S = 32
    return {"frame": rng.normal(size=(97, 3)).astype(np.float32),
            "map": rng.normal(size=(world * S, 3)).astype(np.float32),
            "cols": rng.uniform(size=(world * S, 3)).astype(np.float32),
            "n_map": (world - 1) * S + 7, "n_query": 61}


@functools.lru_cache(maxsize=None)
def _port(world, tmp):
    inp = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in _inputs(world).items()}
    return run_world("points", world, inp, tmp)


@functools.lru_cache(maxsize=None)
def _jax(world):
    inp = _inputs(world)
    mesh = make_mesh(world, axis="map")
    frame = jnp.asarray(inp["frame"])
    map_sh = shard_map_rows(mesh, jnp.asarray(inp["map"]))
    cols_sh = shard_map_rows(mesh, jnp.asarray(inp["cols"]))
    n_map, n_q = inp["n_map"], inp["n_query"]
    loss, idx = knn_points_loss_map_sharded(mesh, map_sh, frame, n_map=n_map, n_query=n_q)
    _, _, win_cols = nn_map_sharded(mesh, frame, map_sh, cols_sh, n_map=n_map, n_query=n_q)
    value, grad = jax.value_and_grad(lambda fr: chamfer_distance_map_sharded(
        mesh, fr, map_sh, n_frame=n_q, n_map=n_map))(frame)
    return {"loss": float(loss), "idx": np.asarray(idx)[:n_q],
            "win_cols": np.asarray(win_cols)[:n_q], "chamfer": float(value),
            "grad": np.asarray(grad)}


@pytest.fixture(scope="module")
def dist_tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("points_sharded"))


@pytest.mark.parametrize("world", [2, 4])
def test_frame_to_map_loss_and_indices(world, dist_tmp):
    want, n_q = _jax(world), _inputs(world)["n_query"]
    for got in _port(world, dist_tmp):
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-6)
        np.testing.assert_array_equal(got["idx"].numpy()[:n_q], want["idx"])


@pytest.mark.parametrize("world", [2, 4])
def test_aux_lookup(world, dist_tmp):
    want, n_q = _jax(world), _inputs(world)["n_query"]
    for got in _port(world, dist_tmp):
        np.testing.assert_array_equal(got["win_cols"].numpy()[:n_q], want["win_cols"])


@pytest.mark.parametrize("world", [2, 4])
def test_chamfer_value_and_frame_gradient(world, dist_tmp):
    want = _jax(world)
    for got in _port(world, dist_tmp):
        np.testing.assert_allclose(float(got["chamfer"]), want["chamfer"], rtol=1e-6)
        np.testing.assert_allclose(got["grad"].numpy(), want["grad"], rtol=1e-5, atol=1e-6)


def test_virtual_shards_chamfer_equals_unsharded():
    """The card's check in one process: 4 virtual shards' frame->map search
    (``shard_search`` + ``combine``) and map->frame parts
    (``map_to_frame_sum``) give ``losses/points.py::chamfer_distance``'s
    value (rtol 1e-6) and frame gradient (rtol 1e-5, atol 1e-6)."""
    inp = _inputs(4)
    S = inp["map"].shape[0] // 4
    n_map, n_q = inp["n_map"], inp["n_query"]
    m = torch.from_numpy(inp["map"])
    f = torch.from_numpy(inp["frame"]).requires_grad_(True)
    parts = [shard_search(f.detach(), m[k * S:(k + 1) * S], k * S, n_map, n_q, with_points=True)
             for k in range(4)]
    _, _, win = combine(*(torch.stack(t) for t in zip(*parts)))
    w = (torch.arange(f.shape[0]) < n_q).float()
    fm = (((f - win) ** 2).sum(dim=-1) * w).sum() / n_q
    mf = sum(map_to_frame_sum(f, m[k * S:(k + 1) * S], min(max(n_map - k * S, 0), S), n_q)
             for k in range(4))
    value = fm + mf / n_map
    value.backward()
    f_ref = torch.from_numpy(inp["frame"]).requires_grad_(True)
    ref = chamfer_distance(f_ref, m, n_a=n_q, n_b=n_map)
    ref.backward()
    np.testing.assert_allclose(float(value.detach()), float(ref.detach()), rtol=1e-6)
    np.testing.assert_allclose(f.grad.numpy(), f_ref.grad.numpy(), rtol=1e-5, atol=1e-6)
