"""The sort cache (``LOSS.knn_sort_period`` > 1: the map's Morton
permutation re-sorted every K keyframes, regathered in between) and the
cross-keyframe KNN seeds it enables, against the JAX runner's per-keyframe
loop and against a fresh sort every keyframe.

A stale permutation and a previous keyframe's seeds change only the
search's pruning and which of two rows tied in float32 wins, never a
distance beyond the score's rounding bound. Those ties are what the
run-level tolerances of tests/test_torch_pft_runs.py (and of
``test_online_adaptation_matches_jax``) allow for, so a run with period 4
is held to the run with period 1 by them, as it is to the JAX runner.
(The JAX package holds its own pair of runs to 0.1% on its seed-0
weights; the port's pair differs by 0.14% in mean abs_rel on the weights
used here.)
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import pytest

from test_torch_pft_runs import BASE, _cfg, check_run, port_run, run_both

from e2eslam_tpu_torch.config import default_config_path, load_yaml


@pytest.fixture(scope="module")
def runs():
    """Period 4 on both sides, and the port's period-1 run on the same
    weights."""
    got, want, weights = run_both({**BASE, "LOSS.knn_sort_period": 4})
    return {"jax": want, 4: got, 1: port_run({**BASE, "LOSS.knn_sort_period": 1}, weights)}


def test_sort_period_run_matches_jax(runs):
    check_run(runs[4], runs["jax"], ("photometric", "three3d"))
    assert runs[4]["regathers"] > 0 and runs[4]["seeded_keyframes"] > 0


@pytest.mark.parametrize("period", [4])
def test_sort_period_gives_the_fresh_sort_run(runs, period):
    a, b = runs[1], runs[period]
    assert a["regathers"] == a["seeded_keyframes"] == 0
    assert b["regathers"] >= 2 and b["seeded_keyframes"] == b["regathers"]
    check_run(b, a, ("photometric", "three3d"))


def test_sort_cache_stale_on_count_decrease():
    """Mirrors tests/test_engine.py::test_sort_cache_stale_on_count_decrease:
    a map count that decreased since the sort (compaction between re-sorts)
    forces a fresh sort, as do an empty or disabled cache, a new bucket and
    an aged-out cache."""
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    cfg = _cfg(load_yaml, default_config_path(), {"DEMO.sequence_length": 4})
    runner = OnlineAdaptation(cfg, device="cpu")

    # period <= 1 or an empty cache: always stale.
    assert runner._sort_cache_stale(1, 1 << 20, 100)
    assert runner._sort_cache_stale(4, 1 << 20, 100)

    runner._sort_cache = {"perm": None, "inv": None, "bucket": 1 << 20, "age": 0,
                          "known": 500}
    assert not runner._sort_cache_stale(4, 1 << 20, 600)  # the count grew: holds
    assert runner._sort_cache_stale(4, 1 << 20, 400)  # it shrank: stale
    assert not runner._sort_cache_stale(4, 1 << 20, 0)  # 0: no count known yet
    assert runner._sort_cache_stale(4, 2 << 20, 600)  # another bucket
    runner._sort_cache["age"] = 3
    assert runner._sort_cache_stale(4, 1 << 20, 600)  # aged out
