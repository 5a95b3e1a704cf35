"""The port's estimated-odometry runs and the PFT step's other 3D-loss
backends against the JAX package.

Runs: ``OnlineAdaptation`` at 64x64 with ``MODEL.odom: gradicp`` (8
iterations) on the brute path and on the index path (index fusion and
association), against the JAX runner with the same weights. Tolerances are
those of the gt-odometry runs (tests/test_torch_pft_runs.py): the same
keyframes; the first two keyframes to 1e-3 relative in abs_rel and loss,
later ones to 5%; the map size to 1%. Estimated poses: the first two
keyframes' to 1e-4 (the odometry's parity bound,
tests/test_torch_odometry.py), later ones to 1e-2: the odometry runs on the
refined depths, which the run holds to 5% (on the brute path
nearest-neighbour near-ties move the third keyframe's abs_rel by 1.1%, and
its pose by 8.0e-3; the index path stays within 3e-7). ATE and RPE to 5e-3
m absolute, half that pose tolerance (2.5e-3 seen, RPE on the brute path).

Steps: one PFT step on frozen inputs (the same weights, a map fused from
the window's ground-truth depths) with ``DATA.use_gt_pose: false`` (view
synthesis through gradICP inside the step), and with ``LOSS.knn_impl``
projective and voxel, each with the chamfer on. Tolerances
(tests/test_torch_engine.py): loss terms 1e-4 relative, gradients 2e-3 of
each tensor's largest entry.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pft_runs import check_run, run_both

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
from e2eslam_tpu_torch.models.depth_net import make_depth_model
from e2eslam_tpu_torch.ops.voxel_knn import VoxelIndex
from e2eslam_tpu_torch.slam.pointclouds import MapState

H = W = 64

RUNS = {
    "brute": {},
    "index": {"MODEL.fusion_impl": "index", "LOSS.knn_impl": "index"},
}


@pytest.mark.parametrize("path", sorted(RUNS))
def test_gradicp_run_matches_jax(path):
    over = {"DEMO.sequence_length": 5, "DEMO.frame_threshold": 0.01,
            "OPTIMIZATION.learning_rate": 1e-5, "MODEL.odom": "gradicp", "MODEL.numiters": 8,
            **RUNS[path]}
    got, want, _ = run_both(over)
    check_run(got, want, ("photometric", "three3d"))
    est, jest = got["est_poses"], np.asarray(want["est_poses"])
    np.testing.assert_allclose(est[:2], jest[:2], atol=1e-4, rtol=0)
    np.testing.assert_allclose(est, jest, atol=1e-2, rtol=0)
    assert np.abs(est - got["gt_kf_poses"]).max() > 1e-4  # the odometry ran
    for key in ("ate", "rpe"):
        assert 0 < got[key] < 0.5
        np.testing.assert_allclose(got[key], float(want[key]), atol=5e-3, rtol=0, err_msg=key)


STEPS = {
    "est_pose": {"DATA.use_gt_pose": False, "MODEL.odom": "gradicp"},
    "projective": {"LOSS.knn_impl": "projective", "LOSS.chamfer_distance": True},
    "voxel": {"LOSS.knn_impl": "voxel", "LOSS.chamfer_distance": True},
}


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


@pytest.fixture(scope="module", params=sorted(STEPS))
def steps(request):
    over = STEPS[request.param]
    cfg = _cfg(jax_load_yaml, jax_default_path(), over)
    ds = SyntheticDataset(seqlen=2, height=H, width=W, dilation=3, total_frames=20)
    colors, depths, K, poses, _ = ds[0]
    colors = (colors / 255.0).astype(np.float32)
    pair = JaxPair(jnp.asarray(colors), jnp.asarray(depths), jnp.asarray(K), jnp.asarray(poses))
    model = jax_model(cfg)
    params, stats = init_depth_model(model, jax.random.key(0), H, W)
    params, stats = _np(params), _np(stats)
    engine = JaxEngine(cfg, model, map_capacity=2 * H * W)
    state = engine.init_state(params, stats, (2, H, W))
    gmap, _ = JaxPointFusion(odom="gt")(pair.colors, pair.gt_depths, pair.intrinsics,
                                         pair.poses, capacity=2 * H * W)
    mi = engine.build_map_index(gmap)
    _, jm, jg = engine.refine_step_with_grads(state, pair, gmap, jax.random.key(0),
                                              map_index=mi)
    pcfg = _cfg(load_yaml, default_config_path(), over)
    net = make_depth_model(pcfg)
    load_jax_params(net, params, stats)
    eng = RefinementEngine(pcfg, net, map_capacity=2 * H * W, device=torch.device("cpu"))
    p = PairBatch(*(torch.from_numpy(np.array(x)) for x in (colors, depths, K, poses)))
    pmap = MapState(data=torch.from_numpy(np.array(gmap.data)), count=int(gmap.count))
    pmi = eng.build_map_index(pmap)
    assert isinstance(pmi, VoxelIndex) == (request.param == "voxel")
    pm, _ = eng.refine_step(p, pmap, pmi)
    return dict(name=request.param, jm=_np(jm), jgrads=_np(jg),
                pm={k: float(v) for k, v in pm.items()},
                grads={n: q.grad for n, q in net.named_parameters()})


def test_step_loss_terms_match(steps):
    jm, pm = steps["jm"], steps["pm"]
    terms = ("photometric", "three3d") + (("chamfer",) if steps["name"] != "est_pose" else ())
    for k in terms + ("total_loss", "abs_rel"):
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    assert pm["three3d"] > 0  # the map is live


def test_step_gradients_match(steps):
    want = from_jax_params(steps["jgrads"], {})
    for name, g in steps["grads"].items():
        w = want[name].numpy()
        if g is None:  # frozen batch norm, or an unused disparity head
            assert not w.any(), name
            continue
        np.testing.assert_allclose(g.numpy(), w, atol=2e-3 * float(np.abs(w).max()), rtol=0,
                                   err_msg=name)
