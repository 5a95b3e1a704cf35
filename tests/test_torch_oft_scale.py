"""Parity of the offline refinement modes with the JAX engine at 64x64, from
the same weights on the same window and ground-truth map:

  * OFT (output fine-tuning): one ``oft_step`` from the frozen forward, and
    ``oft_window`` (R = 3: the frozen forward, a fresh optimizer, the map's
    index, three steps), with brute three3d (tail seeds, the candidate
    table) and smoothness on;
  * SCALE: five ``scale_step`` calls, with and without the bias, and the
    refusal of the depth regularizer;
  * the scale layers ``AffineScale`` and ``ScaleLayer``.

Tolerances: loss terms rtol 1e-4 (tests/test_torch_pft_step.py); the
learned scale and bias rtol 1e-4; the depths after OFT steps rtol 1e-4 or
``DEPTH_ATOL``. Adam's update ``lr g / (|g| + eps)`` of a pixel whose
gradient is of eps's order (1e-8) moves with the gradient's float32
rounding: the widest such gap measured was 2.63e-5 (one pixel of 8192 after
one step at a learning rate of 1e-3), so DEPTH_ATOL is twice that.
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
from e2eslam_tpu_torch.models.convert import load_jax_params
from e2eslam_tpu_torch.models.depth_net import AffineScale, ScaleLayer, make_depth_model
from e2eslam_tpu_torch.slam.pointclouds import MapState

H = W = 64
CPU = torch.device("cpu")
DEPTH_ATOL = 5.3e-5
OFT = {"LOSS.smoothness": True, "OPTIMIZATION.learning_rate": 1e-3,
       "OPTIMIZATION.refinement_steps": 3, "ABLATION.scaled_depth_mode": "constant",
       "ABLATION.scaling_depth": 1.0}
SCALE = {"LOSS.three3d_loss": False, "LOSS.smoothness": True,
         "OPTIMIZATION.learning_rate": 1e-2, "ABLATION.scaled_depth": False}


def _cfg(load, path, over):
    cfg = load(path)
    cfg.DATA.height, cfg.DATA.width = H, W
    for k, v in over.items():
        sec, flag = k.split(".")
        cfg[sec][flag] = v
    return cfg


@pytest.fixture(scope="module")
def scene():
    ds = SyntheticDataset(seqlen=2, height=H, width=W, dilation=3, total_frames=20)
    colors, depths, K, poses, _ = ds[0]
    colors = (colors / 255.0).astype(np.float32)
    cfg = _cfg(jax_load_yaml, jax_default_path(), {})
    model = jax_model(cfg)
    params, stats = init_depth_model(model, jax.random.key(0), H, W)
    params, stats = (jax.tree_util.tree_map(np.asarray, t) for t in (params, stats))
    pair = JaxPair(jnp.asarray(colors), jnp.asarray(depths), jnp.asarray(K), jnp.asarray(poses))
    gmap, _ = JaxPointFusion(odom="gt")(pair.colors, pair.gt_depths, pair.intrinsics,
                                         pair.poses, capacity=2 * H * W)
    return dict(arrays=(colors, depths, K, poses), params=params, stats=stats, pair=pair,
                gmap=gmap)


def _engines(scene, over):
    cfg = _cfg(jax_load_yaml, jax_default_path(), over)
    je = JaxEngine(cfg, jax_model(cfg), map_capacity=2 * H * W)
    state = je.init_state(scene["params"], scene["stats"], (2, H, W))
    pcfg = _cfg(load_yaml, default_config_path(), over)
    net = make_depth_model(pcfg)
    load_jax_params(net, scene["params"], scene["stats"])
    pe = RefinementEngine(pcfg, net, map_capacity=2 * H * W, device=CPU)
    pair = PairBatch(*(torch.from_numpy(np.array(x)) for x in scene["arrays"]))
    gm = scene["gmap"]
    pmap = MapState(data=torch.from_numpy(np.array(gm.data)), count=int(gm.count))
    return je, state, pe, pair, pmap


def _terms_close(pm, jm, keys):
    for k in keys:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, atol=1e-7, err_msg=k)


def test_oft_step_matches(scene):
    je, state, pe, pair, pmap = _engines(scene, OFT)
    jpair, gmap = scene["pair"], scene["gmap"]
    _, jd = je.predict_depth(state, jpair.colors)
    jinit = je._apply_scaling(jd, jpair.gt_depths, intrinsics=jpair.intrinsics)
    jd1, _, jm = je.oft_step(jd, je.optimizer.init(jd), jinit, jpair, gmap, jax.random.key(0),
                             map_index=je.build_map_index(gmap))
    _, pd = pe.predict_depth(pair.colors)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    initial = pe.apply_scaling(pd, pair.gt_depths, pair.intrinsics)
    oft = pe.oft_state(pd)
    pm = pe.oft_step(oft, initial, pair, pmap, pe.build_map_index(pmap))
    _terms_close(pm, jm, ("photometric", "smoothness", "three3d", "total_loss", "abs_rel"))
    assert float(pm["three3d"]) > 0
    np.testing.assert_allclose(oft.depths.detach().numpy(), np.asarray(jd1), rtol=1e-4,
                               atol=DEPTH_ATOL)
    # The step moved the depths by about the learning rate.
    assert float((oft.depths.detach() - pd).abs().max()) > 5e-4


def test_oft_window_matches_and_equals_a_step_loop(scene):
    je, state, pe, pair, pmap = _engines(scene, OFT)
    jd, jm = je.oft_window(state, scene["pair"], scene["gmap"], jax.random.key(0))
    pd, pm = pe.oft_window(pair, pmap)
    _terms_close(pm, jm, ("photometric", "smoothness", "three3d", "total_loss", "abs_rel"))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-4, atol=DEPTH_ATOL)
    # The window's fast path and a loop of oft_step give the same depths.
    _, frozen = pe.predict_depth(pair.colors)
    initial = pe.apply_scaling(frozen, pair.gt_depths, pair.intrinsics)
    oft = pe.oft_state(frozen)
    mi = pe.build_map_index(pmap)
    for _ in range(3):
        pe.oft_step(oft, initial, pair, pmap, mi)
    assert torch.equal(oft.depths.detach(), pd)


@pytest.mark.parametrize("bias", [False, True])
def test_scale_steps_match(scene, bias):
    over = dict(SCALE, **{"ABLATION.with_bias": bias})
    je, state, pe, pair, _ = _engines(scene, over)
    jparams = {"scale": jnp.asarray(2.0)}
    if bias:
        jparams["bias"] = jnp.asarray(0.0)
    jopt = je.optimizer.init(jparams)
    jmap = je.make_empty_map()
    sc = pe.scale_state(2.0, bias)
    pmap = pe.make_empty_map()
    frozen = pe.predict_depth(pair.colors)
    for i in range(5):
        jparams, jopt, jm = je.scale_step(jparams, jopt, state, scene["pair"], jmap,
                                          jax.random.key(i))
        pm = pe.scale_step(sc, pair, pmap, frozen)
        _terms_close(pm, jm, ("photometric", "smoothness", "total_loss", "abs_rel"))
    for k in jparams:
        np.testing.assert_allclose(float(sc.params[k].detach()), float(jparams[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    moved = abs(float(sc.params["scale"].detach()) - 2.0)
    if bias:
        moved += abs(float(sc.params["bias"].detach()))
    assert moved > 0.02, moved  # it learned


def test_scale_refuses_the_depth_regularizer(scene):
    _, _, pe, pair, _ = _engines(scene, dict(SCALE, **{"LOSS.depth_regularizer": True}))
    with pytest.raises(ValueError, match="depth_regularizer"):
        pe.scale_step(pe.scale_state(1.0, False), pair, pe.make_empty_map(),
                      pe.predict_depth(pair.colors))


def test_scale_layers_match():
    from e2eslam_tpu.models.depth_net import AffineScale as JaxAffine
    from e2eslam_tpu.models.depth_net import ScaleLayer as JaxScale

    x = np.random.default_rng(0).uniform(0.5, 4.0, (2, 8, 8, 1)).astype(np.float32)
    for jmod, pmod in ((JaxAffine(init_value=6.0891, use_bias=True),
                        AffineScale(6.0891, use_bias=True)),
                       (JaxAffine(init_value=0.5), AffineScale()),
                       (JaxScale(init_value=3.0), ScaleLayer(3.0))):
        want, variables = jmod.init_with_output(jax.random.key(0), jnp.asarray(x))
        got = pmod(torch.from_numpy(x))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        assert sorted(variables["params"]) == sorted(n for n, _ in pmod.named_parameters())
        grads = torch.autograd.grad(got.sum(), list(pmod.parameters()))
        jg = jax.grad(lambda p: jmod.apply({"params": p}, jnp.asarray(x)).sum())(
            variables["params"])
        for (n, _), g in zip(pmod.named_parameters(), grads):
            np.testing.assert_allclose(float(g), float(jg[n]), rtol=1e-6)
