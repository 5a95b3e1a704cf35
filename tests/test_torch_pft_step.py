"""Parity of one PFT step of the port's engine with the JAX engine, on
frozen inputs with the same weights, for the loss family beyond the
default path:

  * ``all``: every loss flag that draws no random numbers -- geometric,
    smoothness, the depth regularizer (against a given step-0 snapshot),
    auto-masking, three3d with the texture gate and debias, and the exact
    bidirectional chamfer (whose frame->map search reuses three3d's);
  * ``chamfer``: the chamfer alone (``tools/bench_exact.py``'s TUM row:
    three3d off), so both of its searches run on their own seeds;
  * ``forward``: the forward and scaling knobs -- monodepth2 with
    normalised intrinsics, the dual-disparity blend, focal rescaling,
    constant scaling with a bias -- under ``knn_points`` (three3d's alias)
    with world alignment on a 2-strided map.

Tolerances (tests/test_torch_engine.py): loss terms 1e-4 relative,
gradients 2e-3 of each tensor's largest entry. The step's NN indices
(three3d, chamfer a->b and b->a) equal the JAX engine's wherever the
nearest neighbour is unique: where they differ, the float64 distances of
the two picks differ by at most the float32 rounding bound of the score
(``ops/knn.py::fp32_distance_bound``).
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
from e2eslam_tpu_torch.core.se3 import se3_inverse, transform_points
from e2eslam_tpu_torch.engine.refine import PairBatch, RefinementEngine
from e2eslam_tpu_torch.models.convert import from_jax_params, load_jax_params
from e2eslam_tpu_torch.models.depth_net import make_depth_model
from e2eslam_tpu_torch.ops.knn import fp32_distance_bound
from e2eslam_tpu_torch.slam.fusion import frame_pointcloud
from e2eslam_tpu_torch.slam.pointclouds import MapState
from e2eslam_tpu_torch.slam.rgbd import build_frame

# Wider than the other engine tests: the geometric loss is zero at 10000
# valid pixels or fewer (the reference's guard).
H, W = 96, 128

CONFIGS = {
    "all": {"LOSS.geometric": True, "LOSS.smoothness": True,
            "LOSS.depth_regularizer": True, "LOSS.auto_masking": True,
            "LOSS.three3d_texture_gate": 600.0, "LOSS.three3d_debias": True,
            "LOSS.chamfer_distance": True},
    "chamfer": {"LOSS.three3d_loss": False, "LOSS.chamfer_distance": True},
    "forward": {"MODEL.depth_network": "monodepth2", "DATA.normalize_intrinsics": True,
                "ABLATION.dual_disparity": True, "ABLATION.scale_intrinsics": True,
                "ABLATION.scaled_depth_mode": "constant", "ABLATION.with_bias": True,
                "ABLATION.scaling_bias": 0.1, "LOSS.three3d_loss": False,
                "LOSS.knn_points": True, "LOSS.three3d_align": "world",
                "LOSS.three3d_map_stride": 2},
}
TERMS = {"all": ("photometric", "geometric", "smoothness", "depth_reg", "three3d", "chamfer"),
         "chamfer": ("photometric", "chamfer"), "forward": ("photometric", "three3d")}


def _cfg(load, path, over):
    cfg = load(path)
    cfg.DATA.height, cfg.DATA.width = H, W
    cfg.OPTIMIZATION.learning_rate = 1e-4
    for k, v in over.items():
        sec, flag = k.split(".")
        cfg[sec][flag] = v
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def steps(request):
    over = CONFIGS[request.param]
    # --- JAX ---
    cfg = _cfg(jax_load_yaml, jax_default_path(), over)
    ds = SyntheticDataset(seqlen=2, height=H, width=W, dilation=3, total_frames=20)
    colors, depths, K, poses, _ = ds[0]
    colors = (colors / 255.0).astype(np.float32)
    pair = JaxPair(jnp.asarray(colors), jnp.asarray(depths), jnp.asarray(K), jnp.asarray(poses))
    model = jax_model(cfg)
    params, stats = init_depth_model(model, jax.random.key(0), H, W)
    params, stats = _np(params), _np(stats)
    engine = JaxEngine(cfg, model, map_capacity=2 * H * W)
    # Step 1 of a keyframe, so the depth regularizer meets a snapshot that
    # is not the step's own depth.
    init = (depths * 1.05 + 0.02).astype(np.float32)
    state = engine.init_state(params, stats, (2, H, W))._replace(
        step=jnp.ones((), jnp.int32), initial_depths=jnp.asarray(init))
    gmap, _ = JaxPointFusion(odom="gt")(pair.colors, pair.gt_depths, pair.intrinsics,
                                         pair.poses, capacity=2 * H * W)
    mi = engine.build_map_index(gmap)
    step = jax.jit(engine._make_pft_step(return_grads=True, return_knn_cache=True))
    _, jm, jg = step(state, pair, gmap, mi, jax.random.key(0))
    jm = _np(jm)
    # --- port ---
    pcfg = _cfg(load_yaml, default_config_path(), over)
    net = make_depth_model(pcfg)
    load_jax_params(net, params, stats)
    eng = RefinementEngine(pcfg, net, map_capacity=2 * H * W, device=torch.device("cpu"))
    p = PairBatch(*(torch.from_numpy(np.array(x)) for x in (colors, depths, K, poses)))
    pmap = MapState(data=torch.from_numpy(np.array(gmap.data)), count=int(gmap.count))
    pmi = eng.build_map_index(pmap)
    with torch.no_grad():  # the clouds the step's searches see
        _, d = eng.forward_depths(p.colors)
        d = eng.apply_scaling(d, p.gt_depths, p.intrinsics)
        live = frame_pointcloud(build_frame(p.colors[1], d[1], p.intrinsics, p.poses[1]))
        T_rel = se3_inverse(p.poses[0]) @ p.poses[1]
        if pcfg.LOSS.get("three3d_align") == "world":
            T_rel = torch.eye(4)
        pts = transform_points(T_rel, live.points)
        ms = int(pcfg.LOSS.get("three3d_map_stride") or 1)
        map_pts, map_count = pmi.points[::ms], -(-pmap.count // ms)
        pts_safe = torch.where(live.mask[:, None] > 0, pts, torch.full_like(pts, 1e4))
    eng.initial_depths = torch.from_numpy(init)
    pm, cache = eng.refine_step(p, pmap, pmi, thread_knn=True, step=1)
    return dict(name=request.param, jm=jm, jgrads=_np(jg), pm={k: float(v) for k, v in pm.items()},
                grads={n: q.grad for n, q in net.named_parameters()}, cache=cache,
                clouds={"three3d": (pts, map_pts), "ab": (pts, map_pts),
                        "ba": (map_pts[:map_count], pts_safe)})


def test_pft_step_loss_terms_match(steps):
    jm, pm = steps["jm"], steps["pm"]
    for k in TERMS[steps["name"]] + ("total_loss", "abs_rel"):
        assert k in pm, k
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    assert pm[TERMS[steps["name"]][-1]] > 0  # the map is live
    if steps["name"] == "all":
        assert pm["geometric"] > 0 and pm["depth_reg"] > 0


def test_pft_step_gradients_match(steps):
    want = from_jax_params(steps["jgrads"], {})
    for name, g in steps["grads"].items():
        w = want[name].numpy()
        if g is None:  # frozen batch norm, or an unused disparity head
            assert not w.any(), name
            continue
        np.testing.assert_allclose(g.numpy(), w, atol=2e-3 * float(np.abs(w).max()), rtol=0,
                                   err_msg=name)


def test_pft_step_indices_match_where_unique(steps):
    cache, want = steps["cache"], steps["jm"]["_knn_idx"]
    keys = {"all": ("three3d", "ab", "ba"), "chamfer": ("ab", "ba"),
            "forward": ("three3d",)}[steps["name"]]
    assert set(keys) <= set(cache) and "qperm" in cache
    for key in keys:
        q, r = (t.double() for t in steps["clouds"][key])
        got = cache[key][:q.shape[0]].long()
        exp = torch.from_numpy(np.array(want[key])[:q.shape[0]]).long()
        diff = got != exp
        r_got, r_exp = r[got], r[exp]
        gap = (((q - r_got) ** 2).sum(1) - ((q - r_exp) ** 2).sum(1)).abs()
        tol = torch.maximum(fp32_distance_bound(q, r_got), fp32_distance_bound(q, r_exp))
        assert bool((gap[diff] <= tol[diff]).all()), key
        assert int(diff.sum()) <= q.shape[0] // 100, key
