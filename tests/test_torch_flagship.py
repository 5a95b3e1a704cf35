"""Parity of the port's flagship path (``bench.py::flagship_cfg``: index
fusion and association, the bf16 CNN, the fused Adam) with the JAX
package, at 64x64 on the CPU, inputs seeded from numpy.

Tolerances:
  * the index three3d and chamfer losses on frozen inputs (a map fused by
    the JAX package, a noisy depth): values 1e-5 relative, gradients with
    respect to the depth 1e-5 of their largest entry (float32);
  * the bf16 forward of ``DispResNetIndoor`` (flax weights carried over):
    the disparity to 3% relative, twice the widest gap measured (1.5%:
    two bf16 ulps, the two packages rounding their convolutions' float32
    sums at different points), and its mean relative gap below 0.5%
    (0.17% measured); float32 after the engine's cast;
  * the fused Adam against the per-tensor Adam over 3 steps: parameters
    to 1e-7 absolute (a step moves a parameter by at most the learning
    rate, 1e-5);
  * a float32 run with index fusion and association against the JAX
    runner's whole-sequence program: as ``test_torch_engine.py`` holds the
    brute path (the first two keyframes to 1e-3, the rest to 5%, the map to
    1%; 2e-4 and 0.01% measured);
  * a run of the full flagship settings (bf16 CNN, fused Adam): the first
    keyframe (empty map) to 2e-3 in abs_rel and loss (7e-4 measured);
    later keyframes to 6% in abs_rel, total loss and three3d (2.9% the
    widest measured over these 6 frames: the bf16 forward's rounding,
    carried by Adam's normalised steps; the gap grows with the run, to
    6.2% by the 7th keyframe of an 8-frame run); mean abs_rel to 2% (1.0%
    measured), map size to 2% (0.5% measured).
The port's runs pin torch to 8 intra-op threads (``torch_omp.pinned_threads``),
so their numbers do not depend on the host's cores.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)
from torch_omp import pinned_threads

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from e2eslam_tpu.config import default_config_path as jax_default_path
from e2eslam_tpu.config import load_yaml as jax_load_yaml
from e2eslam_tpu.data.synthetic import SyntheticDataset
from e2eslam_tpu.engine.refine import PairBatch as JaxPair
from e2eslam_tpu.engine.refine import RefinementEngine as JaxEngine
from e2eslam_tpu.models.depth_net import init_depth_model, make_depth_model as jax_model
from e2eslam_tpu.slam.fusion import pointfusion_step_index as jax_fuse_index
from e2eslam_tpu.slam.pointclouds import empty_map as jax_empty
from e2eslam_tpu.slam.rgbd import build_frame as jax_frame
from e2eslam_tpu_torch.apps.profile_adaptation import flagship_config
from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.engine.refine import PairBatch, RefinementEngine
from e2eslam_tpu_torch.models.convert import load_jax_params
from e2eslam_tpu_torch.models.depth_net import DispResNetIndoor, make_depth_model
from e2eslam_tpu_torch.slam.pointclouds import map_from_arrays

H = W = 64
THREADS = 8


def _over(cfg, over):
    for k, v in over.items():
        sec, flag = k.split(".")
        cfg[sec][flag] = v
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def seq():
    ds = SyntheticDataset(seqlen=4, height=H, width=W, dilation=2, total_frames=30)
    colors, depths, K, poses, _ = ds[0]
    return (colors / 255.0).astype(np.float32), depths, K, poses


# --------------------------------------------------------------------------
# the 3D losses' index branch on frozen inputs
# --------------------------------------------------------------------------
LOSS_CONFIGS = {
    "plain": {"MODEL.index_levels": 1},
    "knobs": {"MODEL.index_levels": 2, "LOSS.index_assoc_levels": 1,
              "LOSS.three3d_dist_gate": 0.15, "LOSS.three3d_conf_weight": True},
    "two_levels": {"MODEL.index_levels": 2, "LOSS.three3d_conf_weight": True},
}


@pytest.fixture(scope="module", params=sorted(LOSS_CONFIGS))
def losses(request, seq):
    colors, depths, K, poses = seq
    over = {"DATA.height": H, "DATA.width": W, "LOSS.three3d_loss": True,
            "LOSS.chamfer_distance": True, "LOSS.knn_impl": "index",
            "MODEL.fusion_impl": "index", **LOSS_CONFIGS[request.param]}
    cap = 4 * H * W
    # A map of frames 0-2, fused by the JAX package; the pair (2, 3).
    levels = over["MODEL.index_levels"]
    jm = jax_empty(cap, index_hw=H * W, index_levels=levels)
    fuse = jax.jit(jax_fuse_index)
    for i in range(3):
        jm = fuse(jm, jax_frame(*(jnp.asarray(x) for x in (colors[i], depths[i], K, poses[i]))))
    rng = np.random.default_rng(5)
    depth = (depths[2:4] * (1 + 0.02 * rng.normal(size=depths[2:4].shape))).astype(np.float32)
    pair = [x[2:4] for x in (colors, depths)] + [K, poses[2:4]]

    cfg = _over(jax_load_yaml(jax_default_path()), over)
    engine = JaxEngine(cfg, jax_model(cfg), map_capacity=cap)
    jpair = JaxPair(*(jnp.asarray(x) for x in pair))

    def term(d, name):
        out = engine._view_synthesis(jpair, d)
        _, aux = engine._assemble_losses(jpair, 1.0 / d, d, out, jm, jnp.zeros_like(d),
                                         jax.random.key(0))
        return aux[name]

    want = {name: jax.value_and_grad(term)(jnp.asarray(depth), name)
            for name in ("three3d", "chamfer")}

    pcfg = _over(load_yaml(default_config_path()), over)
    eng = RefinementEngine(pcfg, DispResNetIndoor(18), map_capacity=cap,
                           device=torch.device("cpu"))
    pmap = map_from_arrays({k: None if v is None else np.asarray(v)
                            for k, v in jm._asdict().items()})
    ppair = PairBatch(*(_t(x) for x in pair))
    got = {}
    for name in ("three3d", "chamfer"):
        d = _t(depth).requires_grad_(True)
        out = eng.view_synthesis(ppair, d)
        _, aux = eng.assemble_losses(ppair, 1.0 / d, d, out, pmap, torch.zeros_like(d))
        aux[name].backward()
        got[name] = (float(aux[name].detach()), d.grad.numpy())
    return got, want


@pytest.mark.parametrize("name", ["three3d", "chamfer"])
def test_index_losses_match_on_frozen_inputs(losses, name):
    got, want = losses
    value, grad = got[name]
    wv, wg = float(want[name][0]), np.asarray(want[name][1])
    assert value > 0
    np.testing.assert_allclose(value, wv, rtol=1e-5)
    np.testing.assert_allclose(grad, wg, rtol=0, atol=1e-5 * float(np.abs(wg).max()))


# --------------------------------------------------------------------------
# the bf16 CNN, the fused Adam
# --------------------------------------------------------------------------
def test_bf16_forward_matches_flax(seq):
    colors = seq[0][:2]
    jcfg = _over(jax_load_yaml(jax_default_path()),
                 {"DATA.height": H, "DATA.width": W, "SETTINGS.compute_dtype": "bfloat16"})
    model = jax_model(jcfg)
    params, stats = init_depth_model(model, jax.random.key(0), H, W)
    out = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(colors),
                      train=False)[0]
    assert out.dtype == jnp.bfloat16
    want = np.asarray(out.astype(jnp.float32))
    pcfg = _over(load_yaml(default_config_path()),
                 {"DATA.height": H, "DATA.width": W, "SETTINGS.compute_dtype": "bfloat16"})
    net = make_depth_model(pcfg)
    load_jax_params(net, *_np((params, stats)))
    assert all(p.dtype == torch.float32 for p in net.parameters())
    with torch.no_grad():
        raw = net(_t(colors))
    assert raw.dtype == torch.bfloat16
    rel = np.abs(raw.float().numpy() - want) / np.abs(want)
    assert rel.max() < 3e-2 and rel.mean() < 5e-3, (rel.max(), rel.mean())
    eng = RefinementEngine(pcfg, net, map_capacity=H * W, device=torch.device("cpu"))
    with torch.no_grad():
        disp, depth = eng.forward_depths(_t(colors))
    assert disp.dtype == depth.dtype == torch.float32
    np.testing.assert_array_equal(disp.numpy(), raw.float().numpy())


def test_bf16_gradients_reach_float32_parameters(seq):
    pcfg = _over(load_yaml(default_config_path()),
                 {"DATA.height": H, "DATA.width": W, "SETTINGS.compute_dtype": "bfloat16"})
    net = make_depth_model(pcfg)
    net(_t(seq[0][:1])).float().mean().backward()
    conv = net.encoder.conv1.weight
    assert conv.grad is not None and conv.grad.dtype == torch.float32
    assert bool(conv.grad.abs().sum() > 0)


def test_fused_update_matches_per_tensor_adam(seq):
    colors, depths, K, poses = seq
    pair = PairBatch(*(_t(x) for x in (colors[:2], depths[:2], K, poses[:2])))
    params = {}
    for fused in (False, True):
        cfg = _over(load_yaml(default_config_path()),
                    {"DATA.height": H, "DATA.width": W, "OPTIMIZATION.fused_update": fused,
                     "OPTIMIZATION.learning_rate": 1e-5})
        net = make_depth_model(cfg)
        eng = RefinementEngine(cfg, net, map_capacity=2 * H * W, device=torch.device("cpu"))
        assert eng.optimizer.defaults["foreach"] is (True if fused else None)
        for step in range(3):
            eng.refine_step(pair, eng.make_empty_map(), step=step)
        params[fused] = {k: v.clone() for k, v in net.state_dict().items()}
    moved = 0
    before = make_depth_model(cfg).state_dict()
    for k, v in params[False].items():
        np.testing.assert_allclose(params[True][k].numpy(), v.numpy(), rtol=0, atol=1e-7,
                                   err_msg=k)
        moved += int(not torch.equal(v, before[k]))
    assert moved > 0


# --------------------------------------------------------------------------
# online-adaptation runs against the JAX runner's whole-sequence program
# --------------------------------------------------------------------------
def run_both(jcfg, pcfg):
    """The JAX runner (its default program) and the port on the CPU, from
    the same flax weights. Returns (port run, JAX run)."""
    from e2eslam_tpu.engine.adaptation import OnlineAdaptation as JaxRunner

    jr = JaxRunner(jcfg)
    weights = _np((jr.state.params, jr.state.batch_stats))
    want = jr.run(verbose=False)
    return port_run(pcfg, weights), want


def port_run(cfg, weights=None):
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    model = make_depth_model(cfg)
    if weights is not None:
        load_jax_params(model, *weights)
    runner = OnlineAdaptation(cfg, device="cpu", model=model)
    # The per-keyframe loop, as these runs have held it; the port's
    # program is held against the JAX program in tests/test_torch_sequence.py.
    runner.use_sequence_program = False
    with pinned_threads(THREADS):
        return runner.run(verbose=False)


def check_run(got, want, first_rtol, rtol, mean_rtol, map_rtol, close=1):
    assert got["keyframes"] == [int(k) for k in want["keyframes"]]
    assert len(got["keyframes"]) >= 4
    for k, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
        tol = first_rtol if k < close else rtol
        keys = ("abs_rel", "total_loss") + (("three3d",) if k >= close else ())
        for key in keys:
            np.testing.assert_allclose(a[key], float(b[key]), rtol=tol, atol=1e-7,
                                       err_msg=f"{key}, keyframe {k}")
    np.testing.assert_allclose(got["mean_abs_rel"], want["mean_abs_rel"], rtol=mean_rtol)
    assert abs(got["map_points"] - want["map_points"]) <= max(4, map_rtol * want["map_points"])
    np.testing.assert_allclose(got["est_poses"], want["est_poses"], atol=1e-6)


INDEX_F32 = {"DATA.height": H, "DATA.width": W, "DEMO.sequence_length": 6,
             "DEMO.frame_threshold": 0.01, "LOSS.three3d_loss": True,
             "MODEL.fusion_impl": "index", "LOSS.knn_impl": "index"}
FLAGSHIP_64 = {"DATA.height": H, "DATA.width": W, "DEMO.sequence_length": 6}


def test_index_run_matches_jax():
    got, want = run_both(_over(jax_load_yaml(jax_default_path()), INDEX_F32),
                         _over(load_yaml(default_config_path()), INDEX_F32))
    check_run(got, want, 1e-3, 5e-2, 5e-2, 0.01, close=2)
    assert got["metrics"][1]["three3d"] > 0


def test_flagship_settings_match_bench():
    """The port's copy of bench.py's flagship settings equals bench.py's."""
    jcfg = bench.flagship_cfg()
    pcfg = flagship_config(load_yaml(default_config_path()))
    for sec in ("DATA", "DEMO", "OPTIMIZATION", "LOSS", "MODEL", "ABLATION", "SETTINGS"):
        assert dict(pcfg[sec]) == dict(jcfg[sec]), sec


def test_flagship_run_matches_jax():
    got, want = run_both(_over(bench.flagship_cfg(), FLAGSHIP_64),
                         _over(flagship_config(load_yaml(default_config_path())), FLAGSHIP_64))
    check_run(got, want, 2e-3, 6e-2, 2e-2, 0.02)
    assert max(m["three3d"] for m in got["metrics"]) > 0


def test_flagship_run_is_deterministic():
    """Two port runs of the flagship settings give identical metrics (the
    counterpart of tests/test_apps.py::test_flagship_program_is_deterministic)."""
    cfg = _over(flagship_config(load_yaml(default_config_path())), FLAGSHIP_64)
    a, b = port_run(cfg), port_run(cfg)
    assert a["metrics"] == b["metrics"]
    assert a["map_points"] == b["map_points"]
    assert torch.equal(a["map"].data, b["map"].data)
    assert torch.equal(a["map"].index_image, b["map"].index_image)
    np.testing.assert_array_equal(a["est_poses"], b["est_poses"])
