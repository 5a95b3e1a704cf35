"""The port's multi-sequence runner with periodic compaction against the
JAX package's ``ParallelAdaptation`` (``n_seq=2``, 64x64): the index path
with a voxel pass every 2 events on ``tests/test_parallel.py:381-436``'s
data, the JAX runner's whole-run program, from the same weights (the
stacked bridge), to the tolerances of tests/test_torch_parallel_jax.py.
Voxel compaction runs for every sequence, finished or not, as the JAX
runner's (``parallel/adaptation.py:100-126``); each sequence's map
shrinks against the port's run without compaction.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

from test_torch_parallel_jax import COMPACT, H, W, _both, _cfg, _check, _compact_data

from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.models.depth_net import make_depth_model
from e2eslam_tpu_torch.parallel.adaptation import ParallelAdaptation


def test_periodic_compaction_matches_jax():
    data = _compact_data(6)
    got, want = _both(COMPACT, data, "whole")
    counts = _check(got, want)
    n_events = got["num_events"]
    passes = [e for e in range(n_events) if (e + 1) % 2 == 0]
    for r in got["per_sequence"]:
        # voxel compaction runs for every sequence at every second event
        assert [c["keyframe"] for c in r["compactions"]] == passes
        assert all(c["after"] < c["before"] for c in r["compactions"])
    base = {k: v for k, v in COMPACT.items() if not k.startswith("MODEL.compact")}
    tcfg = _cfg(load_yaml, default_config_path(), base)
    par = ParallelAdaptation(tcfg, make_depth_model(tcfg), map_capacity=6 * H * W, n_seq=2,
                             device="cpu")
    plain = par.run(par.init_state(), data, threshold=0.01)
    for r, p, c in zip(got["per_sequence"], plain["per_sequence"], counts):
        assert r["map_points"] < p["map_points"] and c < p["map_points"]
