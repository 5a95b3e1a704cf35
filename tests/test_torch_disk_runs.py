"""Online adaptation on a sequence from disk, and resuming from a checkpoint.

The ICL-NUIM configuration (``configs/config_icl_online.yaml``) on the
repository's 10-frame sequence at 64x96, 6 frames, the settings of the JAX
package's own mini-sequence run (tests/test_disk_datasets.py:164-200; its
weights loaded through ``MODEL.use_pretrained_models`` from a
``depth.pth.tar`` written from the JAX runner's initial weights): the
port's run against the JAX runner's per-keyframe loop, both decoding with
the native loader where it builds (else both with PIL). Tolerances: those
of the brute path's runs (tests/test_torch_pft_runs.py: the same keyframes,
the first two keyframes to 1e-3 in abs_rel and loss, later ones to 5%, the
map to 1%); ATE under 1e-5 (gt odometry reproduces the file's poses).

A run that saves its network (``MODEL.save_checkpoint``) and a runner that
restores it (``MODEL.restore_checkpoint``): the same state dict bit for bit
and the same step-0 disparity.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)
from torch_omp import pinned_threads

import os

import jax
import numpy as np
import pytest
import torch
from test_torch_checkpoint import write_indoor
from test_torch_pft_runs import check_run

import e2eslam_tpu.data.native_loader as jax_native
from e2eslam_tpu.config import load_yaml as jax_load_yaml
from e2eslam_tpu_torch.config import load_yaml
from e2eslam_tpu_torch.data import native_loader
from e2eslam_tpu_torch.models.convert import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ICL_CONFIG = os.path.join(ROOT, "configs", "config_icl_online.yaml")
DATA = os.path.join(ROOT, "tests", "data")


def icl_config(load, ckpt_dir, **over):
    cfg = load(ICL_CONFIG)
    cfg.DATA.data_path = DATA
    cfg.DATA.height, cfg.DATA.width = 64, 96
    cfg.DATA.start, cfg.DATA.dilation, cfg.DATA.stride = 0, 0, 1
    cfg.DEMO.sequence_length = 6
    cfg.DEMO.frame_threshold = 0.01
    cfg.OPTIMIZATION.refinement_steps = 2
    cfg.OPTIMIZATION.learning_rate = 1e-4
    cfg.MODEL.load_depth_path = ckpt_dir
    cfg.DEBUG.print_metrics = False
    cfg.SETTINGS.device = "cpu"
    for k, v in over.items():
        sec, flag = k.split(".")
        cfg[sec][flag] = v
    return cfg


def _seeded():
    from test_torch_checkpoint import seeded_state_dict

    return seeded_state_dict("indoor", seed=4)


def test_icl_run_matches_jax(tmp_path, monkeypatch):
    from e2eslam_tpu.engine.adaptation import OnlineAdaptation as JaxRunner
    from e2eslam_tpu.models.depth_net import init_depth_model
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    both_native = jax_native.native_available() and native_loader.native_available()
    if not both_native:
        # Both packages decode with PIL.
        monkeypatch.setattr(jax_native, "load_rgbd_batch", lambda *a, **k: None)
        monkeypatch.setattr(native_loader, "native_available", lambda: False)
    # The "pretrained" indoor network: the JAX runner's own initial weights,
    # written in the reference's depth.pth.tar layout.
    jcfg = icl_config(jax_load_yaml, str(tmp_path))
    jcfg.MODEL.use_pretrained_models = False
    from e2eslam_tpu.models.depth_net import make_depth_model as jax_model

    params, stats = init_depth_model(jax_model(jcfg), jax.random.key(3), 64, 96)
    write_indoor(str(tmp_path), from_jax_params(*jax.tree_util.tree_map(np.asarray,
                                                                        (params, stats))))
    jr = JaxRunner(icl_config(jax_load_yaml, str(tmp_path)))
    jr.use_sequence_program = False
    want = jr.run(verbose=False)
    runner = OnlineAdaptation(icl_config(load_yaml, str(tmp_path)))
    assert runner.dataset.decoder == ("native" if both_native else "pil")
    K = runner.dataset.intrinsics
    assert K[1, 1] == pytest.approx(-480.0 * 64 / 480, rel=1e-6)
    with pinned_threads(8):
        got = runner.run(verbose=False)
    check_run(got, want, ("photometric", "three3d"))
    assert got["ate"] < 1e-5 and float(want["ate"]) < 1e-5
    assert got["map_points"] > 64 * 96
    assert np.isfinite(got["mean_abs_rel"])


def test_saved_checkpoint_resumes_the_network(tmp_path):
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    ckpt = str(tmp_path / "adapted")
    write_indoor(str(tmp_path / "init"), _seeded())
    cfg = icl_config(load_yaml, str(tmp_path / "init"), **{
        "DEMO.sequence_length": 4, "OPTIMIZATION.optimizer": "RMSprop",
        "MODEL.save_checkpoint": ckpt})
    first = OnlineAdaptation(cfg)
    result = first.run(verbose=False)
    trained = first.engine.model.state_dict()
    with open(os.path.join(ckpt, "manifest.json")) as f:
        assert '"refine_steps": %d' % result["refine_steps"] in f.read()

    cfg2 = icl_config(load_yaml, str(tmp_path / "init"), **{"MODEL.restore_checkpoint": ckpt})
    second = OnlineAdaptation(cfg2)
    resumed = second.engine.model.state_dict()
    assert resumed.keys() == trained.keys()
    for k in trained:
        assert torch.equal(resumed[k], trained[k]), k
    x = torch.from_numpy(second.dataset[0][0][:2] / 255.0).float()
    with torch.no_grad():
        a, b = first.engine.forward_depths(x)[0], second.engine.forward_depths(x)[0]
    assert torch.equal(a, b)
    # The restore takes the network only: the optimizer starts afresh.
    assert not second.engine.optimizer.state_dict()["state"]


def test_cli_runs_the_icl_configuration(tmp_path, capsys):
    from e2eslam_tpu_torch.apps.online_adaption import main

    write_indoor(str(tmp_path), _seeded())
    result = main(["--config_path", ICL_CONFIG, "--data_path", DATA,
                   "--set", "SETTINGS.device=cpu", "--set", "DATA.height=64",
                   "--set", "DATA.width=96", "--set", "DATA.dilation=0",
                   "--set", "DEMO.sequence_length=4", "--set", "DEMO.frame_threshold=0.01",
                   "--set", f"MODEL.load_depth_path={tmp_path}",
                   "--set", "MODEL.compact_voxel=0.02", "--set", "DEBUG.print_metrics=false"])
    out = capsys.readouterr().out
    assert result["num_keyframes"] >= 2 and result["ate"] < 1e-5
    assert f"map points after compaction: {result['map_points_compacted']}" in out
    assert result["map_points_compacted"] < result["map_points"]
