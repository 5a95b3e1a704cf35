"""The port's public names against the JAX package's.

Each subpackage's ``__all__`` holds every name of its JAX counterpart's,
but for the names of JAX machinery (and one name the port's module takes),
each listed in ``COUNTERPARTS`` with the port's name that stands for it;
the names resolve lazily (``e2eslam_tpu_torch/_exports.py``: importing a
subpackage imports none of its modules). The functions the port added for
them are held against their JAX counterparts on the same inputs: the
intrinsics functions, the focal rescaling, the camera-center distance, the
config snapshot, the threaded batch prefetcher (``tests/test_data.py:83-110``'s
cases), the learning-rate schedule and the map's valid view.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import importlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

SUBPACKAGES = ("core", "data", "engine", "losses", "models", "ops", "parallel", "slam",
               "utils", "viz")
# JAX name -> the port's name for it, per subpackage.
COUNTERPARTS = {
    "engine": {"RefineState": "RefinementEngine"},  # the functional state: the engine holds it
    "models": {"init_depth_model": "init_weights",  # flax's variable initialisation
               "convert_torch_state_dict": "load_state_dict_into"},  # into flax trees
    "ops": {"knn_pallas": "KERNELS",  # the Pallas entry: the CUDA kernels' wrappers
            "knn_xla": "dense_plain"},  # the XLA fallback: the plain version
    "parallel": {"shard_leading": "local_rows",  # each rank keeps its own rows
                 "replicate": "Mesh"},  # a rank is a process holding whole values
}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_all_holds_the_jax_names(sub):
    jax_names = set(importlib.import_module(f"e2eslam_tpu.{sub}").__all__)
    port = importlib.import_module(f"e2eslam_tpu_torch.{sub}")
    mapped = COUNTERPARTS.get(sub, {})
    assert set(mapped) <= jax_names
    assert jax_names - set(mapped) <= set(port.__all__), sorted(jax_names - set(port.__all__))
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    for theirs, ours in mapped.items():
        assert ours in port.__all__ and theirs not in port.__all__, (theirs, ours)
    # The JAX package's dispatcher ``ops.knn`` is the port's ``ops.knn.knn``:
    # the name ``knn`` is the module, as the port's own code imports it.
    if sub == "ops":
        assert callable(port.knn.knn) and hasattr(port.knn, "cand_kernel")


def test_subpackages_import_no_module_until_asked():
    code = ("import sys, e2eslam_tpu_torch.ops, e2eslam_tpu_torch.engine, "
            "e2eslam_tpu_torch.parallel\n"
            "bad = [m for m in sys.modules if m.startswith('e2eslam_tpu_torch.')"
            " and m.count('.') > 1]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_intrinsics_functions_match_jax():
    from e2eslam_tpu.core import camera as jc
    from e2eslam_tpu_torch.core import make_intrinsics, scale_intrinsics

    K = make_intrinsics(525.0, 520.5, 319.5, 239.5)
    want = np.asarray(jc.make_intrinsics(525.0, 520.5, 319.5, 239.5))
    np.testing.assert_array_equal(K.numpy(), want)
    np.testing.assert_array_equal(scale_intrinsics(K, 0.5, 0.25).numpy(),
                                  np.asarray(jc.scale_intrinsics(jnp.asarray(want), 0.5, 0.25)))


def test_focal_scaling_and_frame_distance_match_jax():
    from e2eslam_tpu.core import depth as jd
    from e2eslam_tpu.core import se3 as js
    from e2eslam_tpu_torch.core import frame_distance, scale_by_focal, se3_exp

    rng = np.random.default_rng(3)
    depth = rng.uniform(0.5, 4.0, (2, 8, 8, 1)).astype(np.float32)
    np.testing.assert_array_equal(
        scale_by_focal(torch.from_numpy(depth), 481.2, 518.9).numpy(),
        np.asarray(jd.scale_by_focal(jnp.asarray(depth), 481.2, 518.9)))
    xi = torch.from_numpy(rng.normal(size=(2, 5, 6)).astype(np.float32))
    poses = se3_exp(xi)
    got = frame_distance(poses[0], poses[1]).numpy()
    want = np.asarray(js.frame_distance(jnp.asarray(poses[0].numpy()),
                                        jnp.asarray(poses[1].numpy())))
    assert got.shape == want.shape == (5,)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_save_yaml_matches_jax(tmp_path):
    import yaml

    from e2eslam_tpu.config import load_yaml as jax_load
    from e2eslam_tpu.config import save_yaml as jax_save
    from e2eslam_tpu_torch.config import default_config_path, load_yaml, save_yaml

    cfg = load_yaml(default_config_path())
    cfg.SETTINGS.log_path = str(tmp_path / "port")
    cfg.SETTINGS.name = "snap"
    path = save_yaml(cfg)
    assert path == str(tmp_path / "port" / "snap.yaml")
    jcfg = jax_load(default_config_path())
    jcfg.SETTINGS.log_path, jcfg.SETTINGS.name = cfg.SETTINGS.log_path, "snap"
    jpath = jax_save(jcfg, str(tmp_path / "jax.yaml"))
    with open(path) as a, open(jpath) as b:
        assert a.read() == b.read()
    assert load_yaml(save_yaml(cfg, str(tmp_path / "again.yaml"))) == cfg
    assert yaml.safe_load(open(path)) == cfg.to_dict()


def test_prefetch_batches_in_order_and_errors():
    """tests/test_data.py:83-110 against the port: three workers give the
    batches in order, as the caller's thread and the JAX prefetcher do, and
    a worker's exception is raised by the iterator."""
    from e2eslam_tpu.data.pipeline import prefetch_batches as jax_prefetch
    from e2eslam_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
    from e2eslam_tpu_torch.data import SyntheticDataset, prefetch_batches

    ds = SyntheticDataset(seqlen=2, height=32, width=32, total_frames=16, stride=1)
    idxs = [[i] for i in range(6)]
    got = list(prefetch_batches(ds, idxs, num_threads=3))
    ref = list(prefetch_batches(ds, idxs, num_threads=0))
    jds = JaxSynthetic(seqlen=2, height=32, width=32, total_frames=16, stride=1)
    want = list(jax_prefetch(jds, idxs, num_threads=3))
    assert len(got) == len(want) == 6
    for a, b, c in zip(got, ref, want):
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, np.asarray(z))
    on_cpu = next(prefetch_batches(ds, idxs[:1], num_threads=2, device="cpu"))
    assert isinstance(on_cpu[0], torch.Tensor)
    np.testing.assert_array_equal(on_cpu[0].numpy(), got[0][0])

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise RuntimeError("decode failed")
            return ds[0]

    with pytest.raises(RuntimeError, match="decode failed"):
        list(prefetch_batches(Broken(), [[0], [1], [2], [3]], num_threads=2))


@pytest.mark.parametrize("schedule", ["none", "StepLR", "MultiStepLR", "ExponentialLR"])
def test_lr_schedule_matches_jax(schedule):
    from e2eslam_tpu.config import default_config_path as jax_path
    from e2eslam_tpu.config import load_yaml as jax_load
    from e2eslam_tpu.engine.optim import make_lr_schedule as jax_schedule
    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.engine import make_lr_schedule

    over = {"none": {"schedular": None},
            "StepLR": {"schedular": "StepLR", "schedular_step_size": 7},
            "MultiStepLR": {"schedular": "MultiStepLR", "schedular_milestones": [5, 12, 12]},
            "ExponentialLR": {"schedular": "ExponentialLR", "schedular_gamma": 0.9}}[schedule]
    cfgs = [load(path()) for load, path in ((load_yaml, default_config_path),
                                             (jax_load, jax_path))]
    for cfg in cfgs:
        cfg.OPTIMIZATION.learning_rate = 1e-2
        cfg.OPTIMIZATION.update(over)
    ours, theirs = make_lr_schedule(cfgs[0]), jax_schedule(cfgs[1])
    # optax evaluates its schedule in float32 (gamma^count off by a few
    # ulps at count 40); the port's is float64.
    for count in range(40):
        want = float(theirs(count))
        host = ours(count)
        assert isinstance(host, float)
        np.testing.assert_allclose(host, want, rtol=1e-5)
        assert float(ours(torch.tensor(count))) == host


def test_map_points_matches_jax():
    from e2eslam_tpu.slam import pointclouds as jp
    from e2eslam_tpu_torch.slam import map_points
    from e2eslam_tpu_torch.slam.pointclouds import MapState, on_device

    rng = np.random.default_rng(5)
    data = rng.normal(size=(50, 16)).astype(np.float32)
    want_pts, want_mask = jp.map_points(jp.MapState(data=jnp.asarray(data),
                                                    count=jnp.int32(17)))
    for state in (MapState(data=torch.from_numpy(data), count=17),
                  on_device(MapState(data=torch.from_numpy(data), count=17))):
        pts, mask = map_points(state)
        np.testing.assert_array_equal(pts.numpy(), np.asarray(want_pts))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
