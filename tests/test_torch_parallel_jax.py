"""The port's multi-sequence runner against the JAX package's
``ParallelAdaptation`` on a one-device mesh (``n_seq=2``, 64x64).

Both sides start from the same weights: the JAX runner's broadcast state
(a leading ``[2]`` on every leaf) carried over by the stacked bridge
(``models/convert.py::from_jax_params_stacked``). Held per sequence, as
the single-sequence runs of tests/test_torch_pft_runs.py and
tests/test_torch_compact_runs.py are: the same keyframes, each keyframe's
abs_rel to 1e-3 (relative) on the first two and 5% later, the final map
counts to 1% (at least 4 rows), the estimated poses to 1e-6 (the dataset's
poses pass through). The configs draw no random numbers (auto-masking,
min-reprojection and sparse supervision off), so the two packages' random
streams, which cannot match, do not enter.

  * the brute path (exact KNN, texture gate; the JAX test's ragged data:
    one sequence and a frozen-tail copy of another), the JAX runner's
    per-event dispatch (which tests/test_parallel.py:439 pins equal to its
    whole-run program) against the port's program (``dispatch="whole"``,
    every event eager on the CPU, the code the card captures) and against
    the port's per-event loop;
  * the same with the observability outputs (``VIZ.log_gradients``,
    ``DEBUG.plot``): each sequence's gradient norms and debug images at its
    first two keyframes, through both of the port's dispatches, against
    the JAX vmapped step's (read from the JAX runner's per-event calls),
    held as tests/test_torch_sequence.py holds the single-sequence
    program's (``check_observed``);
  * the index path with voxel compaction: tests/test_torch_parallel_compact.py.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import jax
import numpy as np
import pytest
from test_torch_sequence import check_observed

from e2eslam_tpu.config import default_config_path as jax_default_path
from e2eslam_tpu.config import load_yaml as jax_load_yaml
from e2eslam_tpu.data.synthetic import SyntheticDataset
from e2eslam_tpu.models.depth_net import init_depth_model
from e2eslam_tpu.models.depth_net import make_depth_model as jax_model
from e2eslam_tpu.parallel.adaptation import ParallelAdaptation as JaxParallel
from e2eslam_tpu.parallel.mesh import make_mesh as jax_mesh
from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.models.convert import from_jax_params_stacked
from e2eslam_tpu_torch.models.depth_net import make_depth_model
from e2eslam_tpu_torch.parallel.adaptation import ParallelAdaptation

H = W = 64

BRUTE = {"DEMO.sequence_length": 5, "OPTIMIZATION.refinement_steps": 2,
         "LOSS.three3d_texture_gate": 600.0}
OBSERVED = {**BRUTE, "VIZ.log_gradients": True, "DEBUG.plot": True, "DEBUG.plot_path": None}
COMPACT = {"DEMO.sequence_length": 6, "OPTIMIZATION.refinement_steps": 1,
           "MODEL.fusion_impl": "index", "LOSS.knn_impl": "index",
           "MODEL.compact_period": 2, "MODEL.compact_live_voxel": 0.03}


def _cfg(load, path, over):
    cfg = load(path)
    cfg.DATA.name = "synthetic"
    cfg.DATA.height, cfg.DATA.width = H, W
    cfg.DEMO.frame_threshold = 0.01
    cfg.LOSS.three3d_loss = True
    cfg.DEBUG.print_metrics = False
    for key, value in over.items():
        section, flag = key.split(".")
        cfg[section][flag] = value
    cfg.MODEL.map_capacity = int(cfg.DEMO.sequence_length) * H * W
    return cfg


def _brute_data(L):
    ds = SyntheticDataset(seqlen=L, height=H, width=W, dilation=0, stride=2,
                          total_frames=3 * L + 4)
    items = [ds[i] for i in range(3)]
    c, d, p = (items[2][0] / 255.0).copy(), items[2][1].copy(), items[2][3].copy()
    c[2:], d[2:], p[2:] = c[1], d[1], p[1]
    return (np.stack([items[0][0] / 255.0, c]).astype(np.float32),
            np.stack([items[0][1], d]).astype(np.float32),
            np.stack([items[0][2]] * 2).astype(np.float32),
            np.stack([items[0][3], p]).astype(np.float32))


def _compact_data(L):
    ds = SyntheticDataset(seqlen=L, height=H, width=W, dilation=2, stride=3,
                          total_frames=3 * L + 8)
    items = [ds[i] for i in range(2)]
    return tuple(np.stack([it[k] / (255.0 if k == 0 else 1.0) for it in items])
                 .astype(np.float32) for k in range(4))


def _both(over, data, dispatch, port_dispatch="auto", jax_hook=None):
    jcfg = _cfg(jax_load_yaml, jax_default_path(), over)
    L = int(jcfg.DEMO.sequence_length)
    cap = int(jcfg.MODEL.map_capacity)
    model = jax_model(jcfg)
    params, stats = init_depth_model(model, jax.random.key(0), H, W)
    jpar = JaxParallel(jcfg, model, map_capacity=cap, mesh=jax_mesh(1), n_seq=2)
    state = jpar.init_state(params, stats, (2, H, W))
    weights = from_jax_params_stacked(*jax.tree_util.tree_map(
        np.asarray, jax.device_get((state.params, state.batch_stats))))
    if jax_hook is not None:
        jax_hook(jpar)
    want = jpar.run(state, data, threshold=0.01, dispatch=dispatch)
    tcfg = _cfg(load_yaml, default_config_path(), over)
    par = ParallelAdaptation(tcfg, make_depth_model(tcfg), map_capacity=cap, n_seq=2,
                             device="cpu")
    got = par.run(par.init_state(weights), data, threshold=0.01, dispatch=port_dispatch)
    assert L == int(tcfg.DEMO.sequence_length)
    return got, want


def _check(got, want):
    assert got["num_events"] == want["num_events"]
    counts = np.asarray(jax.device_get(want["maps"].count))
    for i, (g, w) in enumerate(zip(got["per_sequence"], want["per_sequence"])):
        assert g["keyframes"] == [int(k) for k in w["keyframes"]], i
        a, b = np.asarray(g["per_pair_abs_rel"]), np.asarray(w["per_pair_abs_rel"])
        np.testing.assert_allclose(a[:2], b[:2], rtol=1e-3)
        np.testing.assert_allclose(a[2:], b[2:], rtol=5e-2)
        np.testing.assert_allclose(g["est_poses"], w["est_poses"], atol=1e-6)
        assert abs(g["map_points"] - int(counts[i])) <= max(4, 0.01 * counts[i]), (
            i, g["map_points"], int(counts[i]))
    return counts


def test_brute_path_matches_jax_event_dispatch():
    got, want = _both(BRUTE, _brute_data(5), "event", "whole")
    assert got["dispatch"] == "whole"
    _check(got, want)
    kf = [r["num_keyframes"] for r in got["per_sequence"]]
    assert kf[1] < kf[0], kf  # ragged


def test_brute_path_event_loop_matches_jax_event_dispatch():
    got, want = _both(BRUTE, _brute_data(5), "event", "event")
    assert got["dispatch"] == "event"
    _check(got, want)


def _record_events(events):
    """A hook that records each per-event call's last-step metrics (the
    leaves ``[N, ...]``) of the JAX runner's event dispatch."""
    def hook(jpar):
        for name in ("_event0", "_event0_all", "_event", "_event_all"):
            def recorded(*args, _fn=getattr(jpar, name)):
                out = _fn(*args)
                events.append(jax.device_get(out[2]))
                return out

            setattr(jpar, name, recorded)

    return hook


@pytest.mark.parametrize("port_dispatch", ["whole", "event"])
def test_observability_outputs_match_jax(port_dispatch):
    events = []
    got, want = _both(OBSERVED, _brute_data(5), "event", port_dispatch, _record_events(events))
    assert got["dispatch"] == port_dispatch
    _check(got, want)
    assert len(events) == want["num_events"]
    assert got["per_sequence"][0]["num_keyframes"] >= 2
    for i, g in enumerate(got["per_sequence"]):
        for k, floor in ((0, 0.0), (1, 2e-5))[:g["num_keyframes"]]:
            theirs = jax.tree_util.tree_map(lambda x, i=i: np.asarray(x[i]), events[k])
            check_observed(g["metrics"][k], theirs, floor, f"sequence {i}, event {k}")


@pytest.mark.parametrize("n_seq", [2])
def test_stacked_bridge_keeps_each_sequence(n_seq):
    """The stacked bridge carries each sequence's own weights: distinct
    per-sequence trees land in their rows (kernels transposed as the
    unstacked bridge does)."""
    from e2eslam_tpu_torch.models.convert import from_jax_params

    jcfg = _cfg(jax_load_yaml, jax_default_path(), BRUTE)
    model = jax_model(jcfg)
    trees = [init_depth_model(model, jax.random.key(s), H, W) for s in range(n_seq)]
    stacked = jax.tree_util.tree_map(lambda *x: np.stack([np.asarray(v) for v in x]), *trees)
    got = from_jax_params_stacked(*stacked)
    for s, (p, b) in enumerate(trees):
        one = from_jax_params(jax.tree_util.tree_map(np.asarray, p),
                              jax.tree_util.tree_map(np.asarray, b))
        assert set(one) == set(got)
        for k, v in one.items():
            assert np.array_equal(got[k][s].numpy(), v.numpy()), k
