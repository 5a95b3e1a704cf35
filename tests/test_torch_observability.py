"""Parity of the observability step with the JAX engine at 64x64, from the
same weights on the same window and ground-truth map (brute three3d with
the texture gate, smoothness, frozen batch norm; ``VIZ.log_gradients``,
``VIZ.grad_images`` and ``DEBUG.plot`` on):

  * ``refine_step_with_grads``: the loss terms (rtol 1e-4), the per-layer
    gradient norms on the same key set -- the port's parameter names are the
    flax paths through ``models/convert.py::torch_key``, the frozen batch
    norm's and the unused disparity heads' norms zero on both sides -- to
    rtol 2e-3, the returned gradients to 2e-3 of each tensor's largest
    entry (tests/test_torch_pft_step.py), zeros included;
  * the decoder's activation gradients (the port's NCHW against the JAX
    package's NHWC ``grad_images``) to 2e-3 of each tap's largest entry;
  * the debug images;
  * ``ScalarLogger``'s JSONL and ``write_histograms``' file against the JAX
    package's for the same scalars and gradients (the ``time`` field aside).
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import json

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
from e2eslam_tpu_torch.models.convert import from_jax_params, load_jax_params, torch_key
from e2eslam_tpu_torch.models.decoders import decoder_tap_shapes
from e2eslam_tpu_torch.models.depth_net import make_depth_model
from e2eslam_tpu_torch.slam.pointclouds import MapState

H = W = 64
OVER = {"LOSS.smoothness": True, "LOSS.three3d_texture_gate": 600.0,
        "OPTIMIZATION.learning_rate": 1e-4, "VIZ.log_gradients": True,
        "VIZ.grad_images": True, "DEBUG.plot": True}


def _cfg(load, path):
    cfg = load(path)
    cfg.DATA.height, cfg.DATA.width = H, W
    for k, v in OVER.items():
        sec, flag = k.split(".")
        cfg[sec][flag] = v
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def step():
    ds = SyntheticDataset(seqlen=2, height=H, width=W, dilation=3, total_frames=20)
    colors, depths, K, poses, _ = ds[0]
    colors = (colors / 255.0).astype(np.float32)
    cfg = _cfg(jax_load_yaml, jax_default_path())
    model = jax_model(cfg)
    params, stats = init_depth_model(model, jax.random.key(0), H, W)
    params, stats = _np(params), _np(stats)
    engine = JaxEngine(cfg, model, map_capacity=2 * H * W)
    state = engine.init_state(params, stats, (2, H, W))
    pair = JaxPair(jnp.asarray(colors), jnp.asarray(depths), jnp.asarray(K), jnp.asarray(poses))
    gmap, _ = JaxPointFusion(odom="gt")(pair.colors, pair.gt_depths, pair.intrinsics,
                                         pair.poses, capacity=2 * H * W)
    _, jm, jg = engine.refine_step_with_grads(state, pair, gmap, jax.random.key(0),
                                              map_index=engine.build_map_index(gmap))
    pcfg = _cfg(load_yaml, default_config_path())
    net = make_depth_model(pcfg)
    load_jax_params(net, params, stats)
    eng = RefinementEngine(pcfg, net, map_capacity=2 * H * W, device=torch.device("cpu"))
    p = PairBatch(*(torch.from_numpy(np.array(x)) for x in (colors, depths, K, poses)))
    pmap = MapState(data=torch.from_numpy(np.array(gmap.data)), count=int(gmap.count))
    pm, _, grads = eng.refine_step_with_grads(p, pmap, eng.build_map_index(pmap), step=0)
    return dict(jm=_np(jm), jg=_np(jg), pm=pm, grads=grads, net=net)


def test_loss_terms_match(step):
    jm, pm = step["jm"], step["pm"]
    for k in ("photometric", "smoothness", "three3d", "total_loss", "abs_rel"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    assert float(pm["three3d"]) > 0


def test_gradient_norms_match_on_the_same_keys(step):
    want = {torch_key(tuple(k.split("/")), "params"): float(v)
            for k, v in step["jm"]["grad_norms"].items()}
    got = {k: float(v) for k, v in step["pm"]["grad_norms"].items()}
    assert set(got) == set(want) == {n for n, _ in step["net"].named_parameters()}
    frozen = {n for n, q in step["net"].named_parameters() if not q.requires_grad}
    assert frozen and all(got[n] == 0.0 == want[n] for n in frozen)
    for k, w in want.items():
        assert np.isfinite(got[k]), k
        if w == 0.0:
            assert got[k] == 0.0, k
        else:
            np.testing.assert_allclose(got[k], w, rtol=2e-3, err_msg=k)
    # Every trainable parameter has a gradient but the disparity heads the
    # indoor network never runs (scales 1-3).
    unused = tuple(f"decoder.{10 + s}." for s in (1, 2, 3))
    trainable = {n for n, q in step["net"].named_parameters() if q.requires_grad}
    assert all(got[n] > 0 for n in trainable if not n.startswith(unused))


def test_returned_gradients_match(step):
    want = from_jax_params(step["jg"], {})
    assert set(step["grads"]) == set(want)
    for name, g in step["grads"].items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=2e-3 * float(np.abs(w).max()), rtol=0,
                                   err_msg=name)


def test_tap_gradients_match(step):
    want, got = step["jm"]["grad_images"], step["pm"]["grad_images"]
    shapes = decoder_tap_shapes(2, H, W)
    assert set(got) == set(want) == set(shapes)
    for k, g in got.items():
        assert tuple(g.shape) == shapes[k] and g.dtype == torch.float32, k
        w = np.transpose(want[k], (0, 3, 1, 2))
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(g.numpy(), w, atol=2e-3 * float(np.abs(w).max()), rtol=0,
                                   err_msg=k)


def test_debug_images_match(step):
    want, got = step["jm"]["debug_images"], step["pm"]["debug_images"]
    assert set(got) == set(want) == {"synthesized_frame", "photometric_error", "depth",
                                     "texture_gate"}
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_logger_and_histogram_files_match(step, tmp_path):
    from e2eslam_tpu.viz.logging import ScalarLogger as JaxLogger
    from e2eslam_tpu.viz.logging import gradient_histograms as jax_hists
    from e2eslam_tpu.viz.logging import write_histograms as jax_write
    from e2eslam_tpu_torch.viz.logging import ScalarLogger, gradient_histograms, write_histograms

    scalars = {k: float(v) for k, v in step["pm"]["grad_norms"].items()}
    grads = {k: v.numpy() for k, v in step["grads"].items()}
    grads["nonfinite"] = np.array([1.0, np.inf, np.nan, -2.0], np.float32)
    files = {}
    for side, logger_cls, hists, write, g in (
            ("jax", JaxLogger, jax_hists, jax_write, grads),
            ("port", ScalarLogger, gradient_histograms, write_histograms,
             {k: torch.from_numpy(v) for k, v in grads.items()})):
        logger = logger_cls(str(tmp_path / side), "obs")
        if logger._tb is not None:  # the JSONL files, whatever imports
            logger._tb.close()
            logger._tb = None
        logger.log(3, scalars, prefix="grad_norm/")
        logger.log(4, {"total_loss": 0.25, "abs_rel": 0.125})
        write(hists(g), logger, step=4)
        write(hists(g), logger, step=4, prefix="grad_act/")
        logger.close()
        recs = [json.loads(line) for line in open(tmp_path / side / "obs.jsonl")]
        for r in recs:
            assert isinstance(r.pop("time"), float)
        files[side] = (recs, open(tmp_path / side / "obs_grad_hists.jsonl").read())
    assert files["port"][0] == files["jax"][0]
    assert files["port"][1] == files["jax"][1]
