"""Parity of the port's engine with ``e2eslam_tpu/engine``: one PFT step
on frozen inputs with the same weights, and a short online-adaptation run.

Tolerances:
  * one step: loss terms 1e-4 relative (float32 CNN forward in another conv
    order, then means over 4096 pixels); gradients 2e-3 of each tensor's
    largest entry (backward through ~20 convolutions); updated parameters
    1e-6 absolute, except where the gradient is within that gradient
    tolerance of zero: Adam's first step is lr * g / (|g| + 1e-8), about
    lr * sign(g), so there the step may flip and the parameters may differ
    by up to twice the learning rate (2e-4).
  * a run: the same keyframes. The first two keyframes (empty map, then one
    3D-loss keyframe) agree to 1e-3 relative in loss and abs_rel. Later,
    nearest-neighbour near-ties (equal distances up to float32 rounding)
    pick different neighbours for a few of 4096 queries, and Adam's
    normalised steps carry that into every parameter: here the JAX
    package's own per-step and whole-sequence paths already differ by 2.6%
    in the third keyframe's abs_rel. So later keyframes are held to 5%,
    and the map size to 1%.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2eslam_tpu.config import default_config_path as jax_default_path
from e2eslam_tpu.config import load_yaml as jax_load_yaml
from e2eslam_tpu.data.synthetic import SyntheticDataset
from e2eslam_tpu.engine.refine import PairBatch as JaxPair
from e2eslam_tpu.engine.refine import RefinementEngine as JaxEngine
from e2eslam_tpu.models.depth_net import init_depth_model, make_depth_model as jax_model
from e2eslam_tpu.slam.slam import PointFusion as JaxPointFusion
from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.engine.refine import PairBatch, RefinementEngine
from e2eslam_tpu_torch.models.convert import from_jax_params, load_jax_params
from e2eslam_tpu_torch.models.depth_net import DispResNetIndoor
from e2eslam_tpu_torch.slam.pointclouds import MapState

H = W = 64


def _cfg(load, path, **over):
    cfg = load(path)
    cfg.DATA.height, cfg.DATA.width = H, W
    cfg.OPTIMIZATION.learning_rate = 1e-4
    for k, v in over.items():
        sec, flag = k.split(".")
        cfg[sec][flag] = v
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def jax_step():
    cfg = _cfg(jax_load_yaml, jax_default_path())
    ds = SyntheticDataset(seqlen=2, height=H, width=W, dilation=3, total_frames=20)
    colors, depths, K, poses, _ = ds[0]
    colors = (colors / 255.0).astype(np.float32)
    pair = JaxPair(jnp.asarray(colors), jnp.asarray(depths), jnp.asarray(K),
                   jnp.asarray(poses))
    model = jax_model(cfg)
    params, stats = init_depth_model(model, jax.random.key(0), H, W)
    params, stats = _np(params), _np(stats)
    engine = JaxEngine(cfg, model, map_capacity=2 * H * W)
    state = engine.init_state(params, stats, (2, H, W))
    # A non-empty map: the pair fused with its GT depths.
    gmap, _ = JaxPointFusion(odom="gt")(pair.colors, pair.gt_depths, pair.intrinsics,
                                         pair.poses, capacity=2 * H * W)
    mi = engine.build_map_index(gmap)
    new_state, metrics, grads = engine.refine_step_with_grads(
        state, pair, gmap, jax.random.key(0), map_index=mi)
    return dict(params=params, stats=stats, colors=colors, depths=depths, K=K,
                poses=poses, map=_np(gmap.data), count=int(gmap.count),
                metrics=_np(metrics), grads=_np(grads), new=_np(new_state.params))


@pytest.fixture(scope="module")
def port_step(jax_step):
    j = jax_step
    cfg = _cfg(load_yaml, default_config_path())
    model = DispResNetIndoor(18)
    load_jax_params(model, j["params"], j["stats"])
    engine = RefinementEngine(cfg, model, map_capacity=2 * H * W, device=torch.device("cpu"))
    pair = PairBatch(*(torch.from_numpy(np.array(x)) for x in
                       (j["colors"], j["depths"], j["K"], j["poses"])))
    gmap = MapState(data=torch.from_numpy(np.array(j["map"])), count=j["count"])
    mi = engine.build_map_index(gmap)
    metrics, cache = engine.refine_step(pair, gmap, mi)
    grads = {n: p.grad for n, p in model.named_parameters()}
    return dict(metrics={k: float(v) for k, v in metrics.items()}, grads=grads,
                new=model.state_dict(), cache=cache)


def test_step_losses_match(jax_step, port_step):
    jm, pm = jax_step["metrics"], port_step["metrics"]
    assert pm["three3d"] > 0  # the map is live
    for k in ("total_loss", "photometric", "three3d", "abs_rel", "rmse", "a1"):
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=1e-4, err_msg=k)
    assert port_step["cache"]["three3d"].shape == (H * W,)


def test_step_gradients_match_and_bn_is_frozen(jax_step, port_step):
    want = from_jax_params(jax_step["grads"], {})
    got = port_step["grads"]
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        if ".bn" in name or "downsample.1" in name:
            assert g is None, name  # frozen batch norm: no gradient
        if g is None:  # frozen, or an unused disparity head (decoder.11-13)
            assert not w.any(), name
            continue
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, atol=2e-3 * scale, rtol=0, err_msg=name)


def test_step_updates_match(jax_step, port_step):
    want = from_jax_params(jax_step["new"], jax_step["stats"])
    got = port_step["new"]
    before = from_jax_params(jax_step["params"], jax_step["stats"])
    grads = from_jax_params(jax_step["grads"], {})
    moved = 0
    for name, w in want.items():
        g = grads.get(name, torch.ones(())).abs()
        tol = torch.where(g <= 2e-3 * g.max(), 2e-4, 1e-6).numpy()
        assert (np.abs(got[name].numpy() - w.numpy()) <= tol).all(), name
        if ".bn" in name or "downsample.1" in name:
            assert torch.equal(got[name], before[name]), name
        else:
            moved += int(not torch.equal(got[name], before[name]))
    assert moved > 0


@pytest.mark.parametrize("sequence_length", [5])
def test_online_adaptation_matches_jax(sequence_length):
    from e2eslam_tpu.engine.adaptation import OnlineAdaptation as JaxRunner
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    over = {"DEMO.sequence_length": sequence_length, "DEMO.frame_threshold": 0.01,
            "OPTIMIZATION.learning_rate": 1e-5}
    jr = JaxRunner(_cfg(jax_load_yaml, jax_default_path(), **over))
    params, stats = _np(jr.state.params), _np(jr.state.batch_stats)
    want = jr.run(verbose=False)
    model = DispResNetIndoor(18)
    load_jax_params(model, params, stats)
    got = OnlineAdaptation(_cfg(load_yaml, default_config_path(), **over),
                           device="cpu", model=model).run(verbose=False)
    assert got["keyframes"] == [int(k) for k in want["keyframes"]]
    assert len(got["keyframes"]) >= 3
    for k, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
        rtol = 1e-3 if k < 2 else 5e-2
        np.testing.assert_allclose(a["abs_rel"], float(b["abs_rel"]), rtol=rtol)
        np.testing.assert_allclose(a["total_loss"], float(b["total_loss"]), rtol=rtol)
    assert got["metrics"][1]["three3d"] > 0
    np.testing.assert_allclose(got["mean_abs_rel"], want["mean_abs_rel"], rtol=5e-2)
    assert abs(got["map_points"] - want["map_points"]) <= max(4, want["map_points"] // 100)
    np.testing.assert_allclose(got["est_poses"], want["est_poses"], atol=1e-6)


def test_unported_settings_are_refused():
    from e2eslam_tpu_torch.engine.refine import validate_config

    refused = {"LOSS.knn_impl": "octree", "SETTINGS.compute_dtype": "float16",
               "OPTIMIZATION.refinement": "OFT"}
    for key, value in refused.items():
        with pytest.raises(NotImplementedError):
            validate_config(_cfg(load_yaml, default_config_path(), **{key: value}))
    with pytest.raises(NotImplementedError):
        validate_config(_cfg(load_yaml, default_config_path(), **{
            "OPTIMIZATION.refinement": "SCALE"}))
    # The JAX package's inconsistent pair: index association, scatter fusion.
    with pytest.raises(ValueError):
        validate_config(_cfg(load_yaml, default_config_path(), **{"LOSS.knn_impl": "index"}))
    with pytest.raises(ValueError):
        validate_config(_cfg(load_yaml, default_config_path(), **{
            "MODEL.compact_period": 4, "MODEL.compact_mode": "octree"}))
    ported = {"LOSS.knn_impl": "index", "MODEL.fusion_impl": "index",
              "OPTIMIZATION.fused_update": True, "SETTINGS.compute_dtype": "bfloat16",
              "LOSS.chamfer_distance": True, "LOSS.knn_points": True, "LOSS.geometric": True,
              "LOSS.smoothness": True, "LOSS.depth_regularizer": True,
              "LOSS.supervise_depth": True, "LOSS.auto_masking": True,
              "LOSS.min_reprojection": True, "LOSS.three3d_texture_gate": 600.0,
              "LOSS.three3d_debias": True, "LOSS.three3d_align": "world",
              "LOSS.three3d_map_stride": 2, "LOSS.knn_sort_period": 4,
              "MODEL.depth_network": "monodepth2", "ABLATION.dual_disparity": True,
              "ABLATION.scale_intrinsics": True, "ABLATION.scaled_depth_mode": "constant",
              "DEMO.sequence_length_refinement": 3, "MODEL.odom": "gradicp",
              "DATA.use_gt_pose": False, "MODEL.active_window": 4096,
              "MODEL.compact_period": 4, "MODEL.compact_mode": "projective",
              "MODEL.compact_voxel": 0.01, "OPTIMIZATION.optimizer": "Adagrad",
              "OPTIMIZATION.schedular": "MultiStepLR"}
    validate_config(_cfg(load_yaml, default_config_path(), **ported))
    for impl in ("projective", "voxel"):
        for fusion in ("scatter", "index"):
            validate_config(_cfg(load_yaml, default_config_path(), **{
                "LOSS.knn_impl": impl, "MODEL.fusion_impl": fusion}))


@pytest.mark.parametrize("quantum", [8192])
def test_bucketed_view_matches_full_buffer(quantum):
    """The per-keyframe bucketed view (KNN, sort and fusion on the buffer's
    first rows, rounded up to LOSS.knn_bucket_quantum) gives the run the
    full buffer gives: every valid row lives in the prefix."""
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    def run(**loss):
        over = {"DEMO.sequence_length": 6, "DEMO.frame_threshold": 0.01}
        over.update({f"LOSS.{k}": v for k, v in loss.items()})
        runner = OnlineAdaptation(_cfg(load_yaml, default_config_path(), **over),
                                  device="cpu")
        seen = []
        build = runner.engine.build_map_index
        runner.engine.build_map_index = lambda m, b=None: (seen.append(b), build(m, b))[1]
        return runner.run(verbose=False), seen

    a, buckets = run(knn_bucket_quantum=quantum)
    b, full = run(knn_bucket=False)
    assert full == [None] * len(full)
    assert buckets == sorted(buckets) and buckets[0] < 6 * H * W  # real slices
    assert a["keyframes"] == b["keyframes"]
    assert abs(a["map_points"] - b["map_points"]) <= max(4, b["map_points"] // 1000)
    np.testing.assert_allclose(a["mean_abs_rel"], b["mean_abs_rel"], rtol=1e-3)
