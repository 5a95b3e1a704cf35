"""The port's multi-sequence runner with periodic compaction against the
JAX package's ``ParallelAdaptation`` (``n_seq=2``, 64x64): the index path
with a pass every 2 events, voxel or projective, on
``tests/test_parallel.py:381-436``'s data with the second sequence frozen
after its third frame (ragged: it runs out of keyframes first), the JAX
runner's whole-run program against the port's (``dispatch="whole"``), from
the same weights (the stacked bridge), to the tolerances of
tests/test_torch_parallel_jax.py. As the JAX runner's
(``parallel/adaptation.py:100-126``), a voxel pass compacts every
sequence's map, finished or not, and a projective pass only the maps of
sequences whose event was active: a finished sequence's map is left alone.
Each sequence's map shrinks against the port's run without compaction, and
each pass's recorded counts (on the device, read at the end) equal the
counts read on the host around the same pass.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import pytest
from test_torch_parallel_jax import COMPACT, H, W, _both, _cfg, _check, _compact_data

from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.engine.refine import RefinementEngine
from e2eslam_tpu_torch.models.depth_net import make_depth_model
from e2eslam_tpu_torch.parallel.adaptation import ParallelAdaptation


def _ragged(data, frozen_from=3):
    """``data`` with the second sequence's frames from ``frozen_from`` on
    repeating the frame before (no camera motion: no more keyframes)."""
    colors, depths, K, poses = (x.copy() for x in data)
    for x in (colors, depths, poses):
        x[1, frozen_from:] = x[1, frozen_from - 1]
    return colors, depths, K, poses


@pytest.mark.parametrize("mode", ["voxel", "projective"])
def test_periodic_compaction_matches_jax(mode, monkeypatch):
    data = _ragged(_compact_data(6))
    over = {**COMPACT, "MODEL.compact_mode": mode}
    host = []
    now = RefinementEngine.compact_now

    def read(engine, ms, *args, **kw):
        before = int(ms.count)
        out = now(engine, ms, *args, **kw)
        host.append((before, int(out.count)))
        return out

    monkeypatch.setattr(RefinementEngine, "compact_now", read)
    got, want = _both(over, data, "whole", "whole")
    monkeypatch.undo()
    assert got["dispatch"] == "whole"
    counts = _check(got, want)
    kf = [r["num_keyframes"] for r in got["per_sequence"]]
    assert kf[1] < kf[0], kf
    passes = [e for e in range(got["num_events"]) if (e + 1) % 2 == 0]
    for r in got["per_sequence"]:
        live = [e for e in passes if e < r["num_keyframes"]]
        assert live, kf
        assert [c["keyframe"] for c in r["compactions"]] == (passes if mode == "voxel" else live)
        for c in r["compactions"]:
            if c["keyframe"] in live:
                assert c["after"] < c["before"], c
            else:
                assert c["after"] <= c["before"], c
    # The program passes event by event, sequence by sequence.
    recorded = sorted((c["keyframe"], j, c["before"], c["after"])
                      for j, r in enumerate(got["per_sequence"]) for c in r["compactions"])
    assert [(b, a) for _, _, b, a in recorded] == host
    base = {k: v for k, v in over.items() if not k.startswith("MODEL.compact")}
    tcfg = _cfg(load_yaml, default_config_path(), base)
    par = ParallelAdaptation(tcfg, make_depth_model(tcfg), map_capacity=6 * H * W, n_seq=2,
                             device="cpu")
    plain = par.run(par.init_state(), data, threshold=0.01)
    for r, p, c in zip(got["per_sequence"], plain["per_sequence"], counts):
        assert r["map_points"] < p["map_points"] and c < p["map_points"]
