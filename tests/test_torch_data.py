"""Parity of the port's config and data layer with the JAX package's:
synthetic frames, depths, intrinsics and poses are byte-identical (both
sides run the same numpy code), and the YAML configs load equal."""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import glob
import os

import numpy as np
import pytest

from e2eslam_tpu.config import default_config_path as jax_default_path
from e2eslam_tpu.config import load_yaml as jax_load_yaml
from e2eslam_tpu.data.pipeline import load_batch as jax_load_batch
from e2eslam_tpu.data.pipeline import make_dataset as jax_make_dataset
from e2eslam_tpu.data.windowing import make_windows as jax_make_windows
from e2eslam_tpu.engine.adaptation import keyframe_schedule as jax_schedule
from e2eslam_tpu_torch.config import default_config_path, load_config, load_yaml
from e2eslam_tpu_torch.data.pipeline import load_batch, make_dataset
from e2eslam_tpu_torch.data.windowing import make_windows
from e2eslam_tpu_torch.engine.adaptation import keyframe_schedule


def _small(cfg, **data):
    cfg.DATA.height, cfg.DATA.width = 64, 96
    cfg.DEMO.sequence_length = 6
    for k, v in data.items():
        cfg.DATA[k] = v
    return cfg


def test_default_config_path_and_yaml_equal():
    assert os.path.samefile(default_config_path(), jax_default_path())
    for path in sorted(glob.glob(os.path.join(os.path.dirname(default_config_path()),
                                              "*.yaml"))):
        assert load_yaml(path).to_dict() == jax_load_yaml(path).to_dict(), path


def test_load_config_cli():
    cfg = load_config(["--name", "x", "--data_path", "/d"])
    assert cfg.SETTINGS.name == "x" and cfg.DATA.data_path == "/d"
    assert cfg.LOSS.knn_impl == "brute" and cfg.MODEL.odom == "gt"


@pytest.mark.parametrize("data", [{}, {"photo_jitter": 0.05, "textureless_frac": 0.3},
                                  {"trajectory": "revisit", "dilation": 0}])
def test_synthetic_batches_byte_identical(data):
    a = make_dataset(_small(load_yaml(default_config_path()), **data))
    b = jax_make_dataset(_small(jax_load_yaml(jax_default_path()), **data))
    assert a.windows == b.windows
    for x, y in zip(load_batch(a, [0]), jax_load_batch(b, [0])):
        assert x.dtype == y.dtype == np.float32
        assert x.tobytes() == y.tobytes()


def test_windows_and_keyframe_schedule_equal():
    for args in [(100, 6, 2, 2, 418 % 50), (30, 4, 0, 1, 0), (10, 20, 0, 1, 0)]:
        assert make_windows(*args) == jax_make_windows(*args)
    cfg = _small(load_yaml(default_config_path()))
    cfg.DEMO.sequence_length = 30
    poses = load_batch(make_dataset(cfg), [0])[3][0]
    for thr in (0.01, 0.03, 0.12):
        assert keyframe_schedule(poses, thr) == jax_schedule(poses, thr)


def test_disk_datasets_are_refused():
    """A dataset name the port does not know, and a disk dataset whose
    directory holds no sequence, are refused (ICL and TUM are ported:
    tests/test_torch_disk_data.py)."""
    cfg = load_yaml(default_config_path())
    cfg.DATA.name = "KITTI"
    with pytest.raises(ValueError, match="unknown dataset"):
        make_dataset(cfg)
    cfg.DATA.name = "ICL"
    cfg.DATA.data_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "no_such_dir")
    with pytest.raises(FileNotFoundError, match="no ICL trajectories"):
        make_dataset(cfg)
