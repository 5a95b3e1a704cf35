"""The port's stacked row ops (``ops/batched_rows.py``) against the JAX
package's ``FLAT_ROW_OPS`` under ``jax.vmap`` (their ``custom_vmap`` rules)
and ``DEFAULT_ROW_OPS``: the flat take and set, the drop index ``N``,
negative and overflowing indices, for B in {1, 3}. Gathers and scatters
move values unchanged, so results must be equal to the bit."""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2eslam_tpu.ops.batched_rows import DEFAULT_ROW_OPS as JAX_DEFAULT
from e2eslam_tpu.ops.batched_rows import FLAT_ROW_OPS as JAX_FLAT
from e2eslam_tpu_torch.ops.batched_rows import DEFAULT_ROW_OPS, FLAT_ROW_OPS

N, C = 11, 4


def _data(B, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, N, C)).astype(np.float32)


@pytest.mark.parametrize("B", [1, 3])
def test_flat_take_matches_jax(B):
    data = _data(B, 0)
    rng = np.random.default_rng(1)
    # In-range indices (the contract), 2-D per sequence: [B, 5, 2].
    idx = rng.integers(0, N, size=(B, 5, 2)).astype(np.int32)
    want = np.asarray(jax.vmap(JAX_FLAT.take)(jnp.asarray(data), jnp.asarray(idx)))
    for ops in (FLAT_ROW_OPS, DEFAULT_ROW_OPS):
        got = ops.take(torch.from_numpy(data), torch.from_numpy(idx)).numpy()
        assert got.shape == (B, 5, 2, C)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B", [1, 3])
def test_flat_take_clips_out_of_range_within_its_sequence(B):
    """A broken contract (negative or past N) stays in its own sequence:
    the JAX rule clips to ``[0, N-1]`` before adding the sequence's base."""
    data = _data(B, 2)
    idx = np.tile(np.array([-5, -1, 0, N - 1, N, N + 7], np.int32), (B, 1))
    want = np.asarray(jax.vmap(JAX_FLAT.take)(jnp.asarray(data), jnp.asarray(idx)))
    got = FLAT_ROW_OPS.take(torch.from_numpy(data), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    for b in range(B):  # never another sequence's rows
        np.testing.assert_array_equal(got[b], data[b][np.clip(idx[b], 0, N - 1)])


@pytest.mark.parametrize("B", [1, 3])
def test_flat_set_matches_jax_with_drops(B):
    """Distinct in-range targets, the drop index ``N``, and out-of-range
    indices (negative, past ``N``): dropped, never landing in the next
    sequence (``batched_rows.py:105-108``)."""
    data = _data(B, 3)
    rng = np.random.default_rng(4)
    idx = np.stack([np.concatenate([rng.permutation(N)[:5], [N, N, -1, -3, N + 2, 2 * N]])
                    for _ in range(B)]).astype(np.int32)
    rows = rng.normal(size=idx.shape + (C,)).astype(np.float32)
    want = np.asarray(jax.vmap(JAX_FLAT.set)(jnp.asarray(data), jnp.asarray(idx),
                                             jnp.asarray(rows)))
    t = (torch.from_numpy(data), torch.from_numpy(idx), torch.from_numpy(rows))
    for ops in (FLAT_ROW_OPS, DEFAULT_ROW_OPS):
        got = ops.set(*t).numpy()
        np.testing.assert_array_equal(got, want)
    # The input buffer is left as it was (a functional update, as JAX's).
    np.testing.assert_array_equal(t[0].numpy(), data)
    # Within the contract ([0, N], N = drop) JAX's per-sequence default ops
    # (``mode="drop"``) give the same buffer.
    inside = idx[:, :7]
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(JAX_DEFAULT.set)(jnp.asarray(data), jnp.asarray(inside),
                                             jnp.asarray(rows[:, :7]))),
        DEFAULT_ROW_OPS.set(t[0], torch.from_numpy(inside),
                            torch.from_numpy(rows[:, :7])).numpy())


def test_window_assembly_is_one_flat_gather():
    """The runner's window assembly (``ParallelAdaptation._gather``): per
    sequence the frames of its window, as the JAX ``gather_pairs_flat``."""
    from e2eslam_tpu_torch.parallel.adaptation import ParallelAdaptation

    rng = np.random.default_rng(5)
    B, L = 3, 6
    colors = torch.from_numpy(rng.uniform(size=(B, L, 4, 5, 3)).astype(np.float32))
    depths = torch.from_numpy(rng.uniform(size=(B, L, 4, 5, 1)).astype(np.float32))
    poses = torch.from_numpy(rng.normal(size=(B, L, 4, 4)).astype(np.float32))
    K = torch.eye(4).expand(B, 4, 4)
    frames = [[0, 2], [3, 4], [5, 5]]
    pair = ParallelAdaptation._gather(colors, depths, K, poses, frames)
    for b, f in enumerate(frames):
        assert torch.equal(pair.colors[b], colors[b, f])
        assert torch.equal(pair.gt_depths[b], depths[b, f])
        assert torch.equal(pair.poses[b], poses[b, f])
