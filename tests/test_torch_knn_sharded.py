"""The port's map-sharded exact KNN (``ops/knn_sharded.py``) against the JAX
package's ``knn_map_sharded`` on the conftest's virtual CPU mesh.

The port runs ``world`` gloo processes (``tests/torch_dist_worker.py``:
torch only, a FileStore rendezvous, a timeout on every join), one shard
each; the JAX side shards the same map over a ``map`` mesh of ``world``
devices. The cases are the JAX tests' (``tests/test_parallel.py:244-291``,
``:358-378``): a valid count ending mid-shard, empty tail shards, the
``nq`` forwarding, and a ``data x map`` layout (gloo subgroups). Each rank
must hold the same result; distances to 1e-6 (relative and absolute),
indices equal (the inputs are random normal points: no ties). The plain
search and combine are also run with virtual shards in one process.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from e2eslam_tpu.ops.knn_sharded import knn_map_sharded as jax_knn_map_sharded
from e2eslam_tpu.ops.knn_sharded import shard_map_rows as jax_shard_map_rows
from e2eslam_tpu.parallel.mesh import make_mesh
from e2eslam_tpu_torch.ops.knn import knn
from e2eslam_tpu_torch.ops.knn_sharded import combine, shard_search, shard_size
from torch_dist_worker import run_world

TOL = dict(rtol=1e-6, atol=1e-6)


def _cases(world):
    """name -> (inputs of one knn_map_sharded call, the number of valid
    queries to compare)."""
    rng = np.random.default_rng(3 + world)
    S = 64
    Nr = world * S

    def pts(n):
        return rng.normal(size=(n, 3)).astype(np.float32)

    cases = {
        # valid rows end inside the last shard but one
        "mid_shard": ({"query": pts(257), "ref": pts(Nr), "nr": (world - 2) * S + 17}, 257),
        # valid rows only in shard 0: every other shard empty; nq forwarded
        "empty_tail": ({"query": pts(64), "ref": pts(Nr), "nr": S - 5, "nq": 41}, 41),
        # every row valid (nr defaults to all), with the winning rows and aux rows
        "payload": ({"query": pts(100), "ref": pts(Nr), "with_points": True,
                     "aux": rng.uniform(size=(Nr, 2)).astype(np.float32)}, 100),
    }
    if world == 4:
        cases["data_map"] = ({"query": pts(65), "ref": pts(2 * 96), "nr": 96 + 33,
                              "layout": "data_map", "map": 2}, 65)
    return cases


@functools.lru_cache(maxsize=None)
def _port(world, tmp):
    """Every case on ``world`` gloo ranks, in one launch."""
    cases = _cases(world)
    inputs = [{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in c.items()} for c, _ in cases.values()]
    ranks = run_world("knn", world, inputs, tmp)
    return {name: [r[i] for r in ranks] for i, name in enumerate(cases)}


def _jax(case, world):
    if case.get("layout") == "data_map":
        m = case["map"]
        mesh = Mesh(np.asarray(jax.devices()[:world]).reshape(world // m, m), ("data", "map"))
    else:
        mesh = make_mesh(world, axis="map")
    aux = case.get("aux")
    ref = jnp.asarray(case["ref"])
    ref = ref if case.get("layout") == "data_map" else jax_shard_map_rows(mesh, ref)
    return jax_knn_map_sharded(
        mesh, jnp.asarray(case["query"]), ref, case.get("nr"), case.get("nq"), axis="map",
        with_points=case.get("with_points", False),
        aux=None if aux is None else jax_shard_map_rows(mesh, jnp.asarray(aux)))


@pytest.fixture(scope="module")
def dist_tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("knn_sharded"))


@pytest.mark.parametrize("world,name", [(2, "mid_shard"), (2, "empty_tail"), (2, "payload"),
                                        (4, "mid_shard"), (4, "empty_tail"), (4, "payload"),
                                        (4, "data_map")])
def test_knn_map_sharded_matches_jax(world, name, dist_tmp):
    case, nq = _cases(world)[name]
    want = [np.asarray(x)[:nq] for x in _jax(case, world)]
    per_rank = _port(world, dist_tmp)[name]
    for got in per_rank:  # every rank holds the whole result
        got = [t.numpy()[:nq] for t in got]
        assert len(got) == len(want)
        np.testing.assert_allclose(got[0], want[0], **TOL)
        np.testing.assert_array_equal(got[1], want[1])
        for g, w in zip(got[2:], want[2:]):  # winning rows, aux rows: gathers
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("D,nr", [(4, 3 * 48 + 5), (4, 48), (3, 0)])
def test_virtual_shards_equal_the_unsharded_search(D, nr):
    """The plain search and combine, D shards in one process (the card's
    check): equal to ``knn`` over the whole map; an empty shard's
    distances are +inf, and an all-empty map picks shard 0."""
    rng = np.random.default_rng(9)
    S = 48
    q = torch.from_numpy(rng.normal(size=(70, 3)).astype(np.float32))
    ref = torch.from_numpy(rng.normal(size=(D * S, 3)).astype(np.float32))
    parts = [shard_search(q, ref[k * S:(k + 1) * S], k * S, nr, with_points=True)
             for k in range(D)]
    for k, part in enumerate(parts):
        if nr <= k * S:
            assert torch.isinf(part[0]).all()
    d2, idx, pts = combine(*(torch.stack(t) for t in zip(*parts)))
    if nr == 0:
        assert torch.isinf(d2).all() and (idx == 0).all()
        return
    d_ref, i_ref = knn(q, ref, nr)
    np.testing.assert_allclose(d2.numpy(), d_ref.numpy(), **TOL)
    np.testing.assert_array_equal(idx.numpy(), i_ref.numpy())
    np.testing.assert_array_equal(pts.numpy(), ref[i_ref.long()].numpy())


def test_shard_size_must_divide():
    assert shard_size(12, 4) == 3
    with pytest.raises(ValueError, match="must divide"):
        shard_size(10, 4)
