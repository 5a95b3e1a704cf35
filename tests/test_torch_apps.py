"""The port's offline apps against the JAX package's on
``tests/test_apps.py::tiny_config`` (64x64 synthetic), from the same flax
weights (``jax.random.key(0)``, the JAX apps' own initialisation):

  * ``train_depth`` on one window of 2 steps: the loss of every step (the
    scalar logs, full precision) to rtol 1e-3 (NN near-ties, ROADMAP
    "Behaviours to know"); the observability outputs and PNG dumps; the
    checkpoint restored into a fresh network;
  * ``train_depth_oft``: the last step's loss and abs_rel, rtol 1e-3;
  * ``absolute_scale`` with the grid [0.5, 2.0]: each learned scale and its
    final loss, rtol 1e-4;
  * ``test_depth_scaling`` (mean abs_rel, rtol 1e-3), ``median_scaling``
    (rtol 1e-5), ``pose_checker`` (under 1e-4 on both sides);
  * the standalone activation-gradient grid, and each app's CLI ``main``.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import json
import os

import jax
import numpy as np
import pytest
import torch

from test_apps import tiny_config as jax_tiny
from e2eslam_tpu.models.depth_net import init_depth_model, make_depth_model as jax_model
from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.models.convert import load_jax_params
from e2eslam_tpu_torch.models.depth_net import make_depth_model

H = W = 64


def tiny(**overrides):
    """The port's ``tiny_config``: the JAX tests' settings, on the CPU."""
    cfg = load_yaml(default_config_path())
    cfg.DATA.name = "synthetic"
    cfg.DATA.height, cfg.DATA.width = H, W
    cfg.DATA.start, cfg.DATA.dilation, cfg.DATA.stride = 0, 2, 2
    cfg.DEMO.sequence_length = 5
    cfg.DEMO.frame_threshold = 0.01
    cfg.OPTIMIZATION.refinement_steps = 2
    cfg.OPTIMIZATION.learning_rate = 1e-4
    cfg.DEBUG.print_metrics = False
    cfg.SETTINGS.device = "cpu"
    for key, value in overrides.items():
        section, flag = key.split(".")
        cfg[section][flag] = value
    return cfg


def _model(cfg):
    """A port network holding the JAX apps' initial weights."""
    params, stats = init_depth_model(jax_model(cfg), jax.random.key(0), H, W)
    net = make_depth_model(cfg)
    load_jax_params(net, *jax.tree_util.tree_map(np.asarray, (params, stats)))
    return net


def _steps(path):
    return [r["total_loss"] for r in map(json.loads, open(path)) if "total_loss" in r]


def test_train_depth_window_matches(tmp_path):
    from e2eslam_tpu.apps.train_depth import train as jax_train
    from e2eslam_tpu_torch.apps.train_depth import train
    from e2eslam_tpu_torch.checkpoint import load_checkpoint

    over = {"LOSS.knn_points": True, "LOSS.smoothness": True}
    jcfg = jax_tiny(**over)
    jcfg.SETTINGS.log_path, jcfg.SETTINGS.name = str(tmp_path / "jax"), "run"
    jax_train(jcfg, max_windows=1, verbose=False)
    cfg = tiny(**over)
    cfg.SETTINGS.log_path, cfg.SETTINGS.name = str(tmp_path / "port"), "run"
    out = train(cfg, max_windows=1, verbose=False, model=_model(cfg))
    want, got = _steps(tmp_path / "jax" / "run.jsonl"), _steps(tmp_path / "port" / "run.jsonl")
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert out["global_step"] == 2 and len(out["first_metrics"]) == 1
    np.testing.assert_allclose(out["first_metrics"][0]["total_loss"], want[0], rtol=1e-3)
    fresh = make_depth_model(cfg)
    meta = load_checkpoint(out["checkpoint"], fresh)
    assert meta == {"global_step": 2}
    a, b = out["engine"].model.state_dict(), fresh.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_train_depth_observability(tmp_path):
    """tests/test_apps.py::test_train_depth_observability on the port:
    per-layer gradient norms in the scalar log, gradient histograms, the
    debug PNGs at the reference's cadence and the activation-gradient grid."""
    from e2eslam_tpu_torch.apps.train_depth import train
    from e2eslam_tpu_torch.models.decoders import decoder_tap_shapes

    cfg = tiny(**{"DATA.frames": [0, -1], "LOSS.three3d_texture_gate": 600.0})
    cfg.SETTINGS.log_path, cfg.SETTINGS.name = str(tmp_path / "logs"), "obs_test"
    cfg.VIZ.log_gradients = cfg.VIZ.grad_images = cfg.VIZ.tensorboard_scaled = True
    cfg.DEBUG.plot, cfg.DEBUG.plot_path = True, str(tmp_path / "plots")
    out = train(cfg, max_windows=1, verbose=False)
    records = [json.loads(line) for line in open(tmp_path / "logs" / "obs_test.jsonl")]
    norms = {k: v for r in records for k, v in r.items() if k.startswith("grad_norm/")}
    assert any(k.startswith("grad_norm/decoder.") for k in norms)
    assert any(k.startswith("grad_norm/encoder.") for k in norms)
    assert all(np.isfinite(v) for v in norms.values())
    assert set(out["grad_norms"]) == {n for n, _ in out["engine"].model.named_parameters()}
    assert {k: tuple(v.shape) for k, v in out["grad_images"].items()} == decoder_tap_shapes(
        2, H, W)
    plots = os.listdir(tmp_path / "plots")
    for part in ("synth", "photo_err", "depth", "texgate", "step0_tF", "step0_sF",
                 "step0_depth", "grad_upconv_0_1"):
        assert any(part in p for p in plots), (part, plots)
    logs = os.listdir(tmp_path / "logs")
    assert any("tfevents" in f for f in logs) or any(f.endswith("_grad_hists.jsonl")
                                                     for f in logs)


def test_grad_images_standalone(tmp_path):
    """VIZ.grad_images with no logger renders the designated layer's grid
    into DEBUG.plot_path; ``render=False`` computes it and writes nothing."""
    from e2eslam_tpu_torch.apps.train_depth import train

    cfg = tiny(**{"OPTIMIZATION.refinement_steps": 1, "DATA.frames": [0, -1]})
    cfg.VIZ.grad_images = True
    cfg.DEBUG.plot_path = str(tmp_path / "plots")
    out = train(cfg, max_windows=1, verbose=False)
    assert any("grad_upconv_0_1" in p for p in os.listdir(tmp_path / "plots"))
    cfg.DEBUG.plot_path = str(tmp_path / "none")
    out = train(cfg, max_windows=1, verbose=False, render=False)
    assert "upconv_0_1" in out["grad_images"] and not os.path.exists(tmp_path / "none")


def test_train_depth_oft_matches():
    from e2eslam_tpu.apps.train_depth_oft import train as jax_train
    from e2eslam_tpu_torch.apps.train_depth_oft import train

    over = {"OPTIMIZATION.learning_rate": 1e-3}
    want = jax_train(jax_tiny(**over), max_windows=1, verbose=False)["metrics"][-1]
    cfg = tiny(**over)
    out = train(cfg, max_windows=1, verbose=False, model=_model(cfg))
    got = out["metrics"][-1]
    for k in ("total_loss", "abs_rel", "three3d"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-3, err_msg=k)
    assert out["depths"].shape == (2, H, W, 1)


def test_absolute_scale_grid_matches():
    from e2eslam_tpu.apps.absolute_scale import train_scale as jax_scale
    from e2eslam_tpu_torch.apps.absolute_scale import train_scale

    over = {"OPTIMIZATION.learning_rate": 1e-2, "ABLATION.with_bias": True}
    jcfg = jax_tiny(**over)
    jcfg.SCALE_GRID_SEARCH.grid = [0.5, 2.0]
    want = jax_scale(jcfg, max_windows=1, verbose=False)
    cfg = tiny(**over)
    cfg.SCALE_GRID_SEARCH.grid = [0.5, 2.0]
    got = train_scale(cfg, max_windows=1, verbose=False, model=_model(cfg))
    assert len(got["results"]) == len(want["results"]) == 2
    for g, w in zip(got["results"], want["results"]):
        for k in ("scale", "bias", "final_loss", "abs_rel"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert got["best"]["init"] == want["best"]["init"]


def test_scaling_tools_match():
    from e2eslam_tpu.apps.median_scaling import find_median_scale as jax_median
    from e2eslam_tpu.apps.pose_checker import check as jax_check
    from e2eslam_tpu.apps.test_depth_scaling import evaluate as jax_evaluate
    from e2eslam_tpu_torch.apps.median_scaling import find_median_scale
    from e2eslam_tpu_torch.apps.pose_checker import check
    from e2eslam_tpu_torch.apps.test_depth_scaling import evaluate

    over = {"ABLATION.scaling_depth": 3.0, "ABLATION.with_bias": True,
            "ABLATION.scaling_bias": 0.1}
    want = jax_evaluate(jax_tiny(**over), max_windows=1, verbose=False)
    cfg = tiny(**over)
    got = evaluate(cfg, max_windows=1, verbose=False, model=_model(cfg))
    np.testing.assert_allclose(got["mean_abs_rel"], want["mean_abs_rel"], rtol=1e-3)
    cfg = tiny()
    scale = find_median_scale(cfg, max_windows=3, model=_model(cfg))
    np.testing.assert_allclose(scale, jax_median(jax_tiny(), max_windows=3), rtol=1e-5)
    assert 0.01 < scale < 100
    err, jerr = check(tiny(), verbose=False), jax_check(jax_tiny(), verbose=False)
    assert err < 1e-4 and jerr < 1e-4


def test_depth_dumps(tmp_path):
    """test_depth_scaling's DEBUG.plot dumps: the scaled target depth every
    DUMP_EVERY steps, as the engine scales it."""
    from e2eslam_tpu_torch.apps.test_depth_scaling import DUMP_EVERY, evaluate

    cfg = tiny(**{"OPTIMIZATION.refinement_steps": DUMP_EVERY + 1,
                  "ABLATION.scaling_depth": 3.0})
    cfg.DEBUG.plot, cfg.DEBUG.plot_path = True, str(tmp_path)
    out = evaluate(cfg, max_windows=1, verbose=False)
    assert [os.path.basename(p) for p in out["dumps"]] == [
        "depth_it0_rs0.npy", f"depth_it0_rs{DUMP_EVERY}.npy"]
    d = np.load(out["dumps"][0])
    assert d.shape == (H, W) and np.isfinite(d).all() and d.min() > 0


TINY_ARGS = ["--set", "SETTINGS.device=cpu", "--set", "DATA.height=64",
             "--set", "DATA.width=64", "--set", "DATA.start=0", "--set", "DEMO.sequence_length=5",
             "--set", "DEMO.frame_threshold=0.01", "--set", "OPTIMIZATION.refinement_steps=1",
             "--set", "DEBUG.print_metrics=false", "--set", "DEBUG.early_stop=true",
             "--set", "SCALE_GRID_SEARCH.grid=[1.0]"]


@pytest.mark.parametrize("app", ["train_depth", "train_depth_oft", "absolute_scale",
                                 "test_depth_scaling", "median_scaling", "pose_checker",
                                 "gradient_experiments", "demo"])
def test_cli_main(app, tmp_path, capsys):
    import importlib

    mod = importlib.import_module(f"e2eslam_tpu_torch.apps.{app}")
    out = mod.main(["--config_path", default_config_path(), "--name", "cli", *TINY_ARGS,
                    "--set", f"DEBUG.plot_path={tmp_path}"])
    printed = capsys.readouterr().out
    assert out is not None and printed.strip()
    if app == "pose_checker":
        assert "PASS" in printed
    if app == "demo":
        assert os.path.exists(tmp_path / "cli_demo" / "map_update.html")
