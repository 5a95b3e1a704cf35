"""Short online-adaptation runs of the port against the JAX runner for the
loss family beyond the default path: the exact bidirectional chamfer
(three3d off), and 3-frame windows with min-reprojection.

The JAX runner takes its per-keyframe loop (``use_sequence_program =
False``; 3-frame windows take it anyway). Tolerances: those of
``test_online_adaptation_matches_jax`` (tests/test_torch_engine.py): the
same keyframes; the first two keyframes (empty map, then one 3D-loss
keyframe) to 1e-3 relative in loss and abs_rel, later ones to 5%
(nearest-neighbour near-ties pick different neighbours for a few queries
and Adam's normalised steps spread that); the map size to 1%.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)
from torch_omp import pinned_threads

import jax
import numpy as np
import pytest

from e2eslam_tpu.config import default_config_path as jax_default_path
from e2eslam_tpu.config import load_yaml as jax_load_yaml
from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.models.convert import load_jax_params
from e2eslam_tpu_torch.models.depth_net import make_depth_model

H = W = 64


def _cfg(load, path, over):
    cfg = load(path)
    cfg.DATA.height, cfg.DATA.width = H, W
    for k, v in over.items():
        sec, flag = k.split(".")
        cfg[sec][flag] = v
    return cfg


def run_both(over, threads=None):
    """The JAX runner and the port on the same config and weights. Returns
    (port run, JAX run, the weights). ``threads``: torch's intra-op thread
    count for the port's run (default: left as it is)."""
    from e2eslam_tpu.engine.adaptation import OnlineAdaptation as JaxRunner

    jr = JaxRunner(_cfg(jax_load_yaml, jax_default_path(), over))
    jr.use_sequence_program = False
    weights = jax.tree_util.tree_map(np.asarray, jax.device_get(
        (jr.state.params, jr.state.batch_stats)))
    want = jr.run(verbose=False)
    if threads is None:
        return port_run(over, weights), want, weights
    with pinned_threads(threads):
        return port_run(over, weights), want, weights


def port_run(over, weights):
    """The port's per-keyframe loop on the CPU from the JAX package's flax
    weights (its whole-sequence program: tests/test_torch_sequence.py)."""
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    cfg = _cfg(load_yaml, default_config_path(), over)
    model = make_depth_model(cfg)
    load_jax_params(model, *weights)
    runner = OnlineAdaptation(cfg, device="cpu", model=model)
    runner.use_sequence_program = False  # held against the JAX runner's loop
    return runner.run(verbose=False)


def check_run(got, want, terms, close=2, map_rtol=0.01):
    """The run's keyframes and maps agree: the first ``close`` keyframes to
    1e-3 in abs_rel, the total loss and each of ``terms``; every keyframe
    to 5% in abs_rel and the total loss (as the default run is held); the
    map size to ``map_rtol``."""
    assert got["keyframes"] == [int(k) for k in want["keyframes"]]
    assert len(got["keyframes"]) >= 3
    for k, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
        assert all(np.isfinite(a[key]) for key in terms)
        keys = ("abs_rel", "total_loss") + (terms if k < close else ())
        for key in keys:
            np.testing.assert_allclose(a[key], float(b[key]), rtol=1e-3 if k < close else 5e-2,
                                       atol=1e-7, err_msg=f"{key}, keyframe {k}")
    np.testing.assert_allclose(got["mean_abs_rel"], want["mean_abs_rel"], rtol=5e-2)
    assert abs(got["map_points"] - want["map_points"]) <= max(4, map_rtol * want["map_points"])


BASE = {"DEMO.sequence_length": 5, "DEMO.frame_threshold": 0.01,
        "OPTIMIZATION.learning_rate": 1e-5}


def test_chamfer_run_matches_jax():
    got, want, _ = run_both({**BASE, "LOSS.three3d_loss": False, "LOSS.chamfer_distance": True})
    check_run(got, want, ("photometric", "chamfer"))
    assert got["metrics"][0]["chamfer"] == 0.0  # the empty map's gate
    assert got["metrics"][1]["chamfer"] > 0


@pytest.mark.parametrize("frames", [3])
def test_three_frame_min_reprojection_run_matches_jax(frames):
    """Windows of the last three keyframes, the middle one the target, the
    photometric loss the minimum over both sources; fusion still takes the
    newest pair. Held to 5% from the first keyframe: its window repeats
    frame 0 (no older keyframe yet), so one source is the target itself,
    and its near-identity warp puts the border pixels' validity test on
    |grid| = 1 exactly, a float32 tie that the two packages' matmuls break
    differently (their masked losses there differ by ~1%), and the map
    size to 2% (1.1% seen: the trajectories part from that first keyframe
    on, by up to 3% in abs_rel). The port's run has torch's thread count
    pinned to 8: the count sets torch's reduction splits, and the margin is
    thin (at 2 threads the third keyframe's loss was 5.3% off)."""
    got, want, _ = run_both({**BASE, "DEMO.sequence_length_refinement": frames,
                             "LOSS.min_reprojection": True}, threads=8)
    check_run(got, want, ("photometric", "three3d"), close=0, map_rtol=0.02)
