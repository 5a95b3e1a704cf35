"""The port's utilities and exports against the JAX package's:

  * corruption: ``remove_pixels`` and ``replace_image`` exactly; the noise's
    range and shape (the draws come from a ``torch.Generator``); the depth
    noise scaled by the population standard deviation (``jnp.std``);
    ``corrupt_rgbd``'s dispatch flag by flag;
  * ``average_focal`` and ``average_focal_from_dir``;
  * the PLY bytes of the same map, whole and subsampled;
  * the animation's figure dict for the same snapshots, poses and
    intrinsics, and its HTML read back;
  * the Demo on a 5-frame 64x64 run: one snapshot per keyframe with the JAX
    Demo's counts (within 1% or 4 points, tests/test_torch_engine.py's map
    tolerance), never decreasing, the last equal to the final map's.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_apps import tiny_config as jax_tiny
from e2eslam_tpu.slam.pointclouds import MapState as JaxMap
from e2eslam_tpu_torch.slam.pointclouds import MapState
from e2eslam_tpu_torch.utils import corruption

FLAGS = ("noise_depth", "noise_color", "remove_pixels_depth", "remove_pixels_color",
         "replace_depth", "replace_color")


def _seq(seed=0):
    rng = np.random.default_rng(seed)
    colors = rng.uniform(0, 1, (1, 3, 16, 20, 3)).astype(np.float32)
    depths = rng.uniform(0.5, 4.0, (1, 3, 16, 20, 1)).astype(np.float32)
    return colors, depths


def test_remove_pixels_and_replace_image_exact():
    from e2eslam_tpu.utils import corruption as jc

    colors, depths = _seq()
    for x in (colors, depths):
        np.testing.assert_array_equal(corruption.remove_pixels(torch.from_numpy(x), 6, 9).numpy(),
                                      np.asarray(jc.remove_pixels(jnp.asarray(x), 6, 9)))
        np.testing.assert_array_equal(corruption.replace_image(torch.from_numpy(x), 0.25).numpy(),
                                      np.asarray(jc.replace_image(jnp.asarray(x), 0.25)))
    with pytest.raises(ValueError):
        corruption.remove_pixels(torch.from_numpy(colors), 16, 4)


def test_noise_range_shape_and_population_std():
    colors, depths = _seq()
    c, d = torch.from_numpy(colors), torch.from_numpy(depths)
    gen = torch.Generator().manual_seed(0)
    std, mean = d.std(correction=0), d.mean()
    np.testing.assert_allclose(float(std), float(jnp.std(jnp.asarray(depths))), rtol=1e-6)
    nd = corruption.noise_depth(gen, d, std, mean)
    assert nd.shape == d.shape and torch.equal(nd[:, :-1], d[:, :-1])
    assert float(nd[:, -1].min()) >= float(mean) and float(nd[:, -1].max()) < float(mean + std)
    nc = corruption.noise_color(gen, c)
    assert nc.shape == c.shape and torch.equal(nc[:, :-1], c[:, :-1])
    assert 0.0 <= float(nc[:, -1].min()) and float(nc[:, -1].max()) < 1.0
    assert float(nc[:, -1].std()) > 0.2  # white noise, not a copy
    with pytest.raises(ValueError):
        corruption.noise_depth(gen, c, std, mean)
    with pytest.raises(ValueError):
        corruption.noise_color(gen, d)


@pytest.mark.parametrize("flag", FLAGS)
def test_corrupt_rgbd_dispatch(flag):
    from e2eslam_tpu.utils.corruption import corrupt_rgbd as jax_corrupt
    from e2eslam_tpu_torch.config import default_config_path, load_yaml

    cfg = load_yaml(default_config_path())
    jcfg = jax_tiny()
    for f in FLAGS:
        cfg.DEPTH_RECOVER[f] = jcfg.DEPTH_RECOVER[f] = f == flag
    cfg.DEPTH_RECOVER.mask_height = jcfg.DEPTH_RECOVER.mask_height = 6
    cfg.DEPTH_RECOVER.mask_width = jcfg.DEPTH_RECOVER.mask_width = 8
    colors, depths = _seq(1)
    jc, jd = (np.asarray(x) for x in jax_corrupt(jcfg, jax.random.key(0), colors, depths))
    pc, pd = (x.numpy() for x in corruption.corrupt_rgbd(
        cfg, torch.Generator().manual_seed(0), torch.from_numpy(colors),
        torch.from_numpy(depths)))
    # The same frames change; deterministic corruptions change them equally.
    for want, got, orig in ((jc, pc, colors), (jd, pd, depths)):
        assert np.array_equal(want == orig, got == orig), flag
        if not flag.startswith("noise"):
            np.testing.assert_array_equal(got, want)
        else:
            lo, hi = want[:, -1].min(), want[:, -1].max()
            assert got.shape == want.shape
            if not np.array_equal(want, orig):
                assert abs(got[:, -1].min() - lo) < 0.1 * (hi - lo) + 1e-3
                assert abs(got[:, -1].max() - hi) < 0.1 * (hi - lo) + 1e-3


def test_average_focal(tmp_path):
    from e2eslam_tpu.utils.focal import average_focal as jax_avg
    from e2eslam_tpu.utils.focal import average_focal_from_dir as jax_avg_dir
    from e2eslam_tpu_torch.utils.focal import average_focal, average_focal_from_dir

    Ks = [np.array([[518.8, 0, 325.5], [0, 519.5, 253.7], [0, 0, 1]]),
          np.array([[481.2, 0, 319.5, 0], [0, -480.0, 239.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]])]
    assert average_focal(Ks) == jax_avg(Ks)
    np.savetxt(tmp_path / "a.txt", Ks[0])
    np.savetxt(tmp_path / "b.txt", Ks[1])
    np.savetxt(tmp_path / "c.txt", Ks[0].ravel()[None])
    assert average_focal_from_dir(str(tmp_path)) == jax_avg_dir(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        average_focal_from_dir(str(tmp_path), "*.none")
    with pytest.raises(ValueError):
        average_focal([])


def _map(n=3000, count=2500, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(0, 1, (n, 16)).astype(np.float32)
    data[:, 6:9] = rng.uniform(-0.2, 1.2, (n, 3))
    return data, count


@pytest.mark.parametrize("max_points", [None, 700])
def test_ply_bytes_equal(tmp_path, max_points):
    from e2eslam_tpu.viz.pointcloud_export import export_ply as jax_ply
    from e2eslam_tpu_torch.viz.pointcloud_export import export_ply

    data, count = _map()
    jax_ply(JaxMap(data=jnp.asarray(data), count=jnp.int32(count)), str(tmp_path / "j.ply"),
            max_points=max_points)
    export_ply(MapState(data=torch.from_numpy(data), count=count), str(tmp_path / "p.ply"),
               max_points=max_points)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_animation_figure_equal(tmp_path):
    from e2eslam_tpu.viz.animation import map_update_figure as jax_fig
    from e2eslam_tpu_torch.viz.animation import (
        map_update_figure, read_animation_html, write_animation_html)
    from e2eslam_tpu_torch.viz.pointcloud_export import plotly_figure

    snaps = [_map(800, c, seed=c) for c in (300, 500, 800)]
    rng = np.random.default_rng(3)
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[:, :3, 3] = rng.normal(0, 1, (3, 3))
    K = np.array([[100.0, 0, 32, 0], [0, 100.0, 32, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    want = jax_fig([JaxMap(data=jnp.asarray(d), count=jnp.int32(c)) for d, c in snaps], poses, K,
                   max_points_per_frame=400)
    got = map_update_figure([MapState(data=torch.from_numpy(d), count=c) for d, c in snaps],
                            poses, K, max_points_per_frame=400)
    assert got == want
    back = read_animation_html(write_animation_html(got, str(tmp_path / "a.html")))
    assert back == want and len(back["frames"]) == 3
    try:
        import plotly  # noqa: F401
        has_plotly = True
    except ImportError:
        has_plotly = False
    fig = plotly_figure(MapState(data=torch.from_numpy(snaps[0][0]), count=100))
    assert (fig is None) == (not has_plotly)


def _jax_demo_counts(cfg):
    """The JAX Demo's snapshot counts. Its own hook takes ``process_pair``'s
    arguments as of before the loop passed ``return_knn_cache`` and so
    raises a TypeError on its first keyframe (ROADMAP.md, section C.3): the
    same hook is rebuilt here around the engine's method, taking whatever
    the loop passes."""
    from e2eslam_tpu.apps.demo import Demo as JaxDemo

    demo = JaxDemo(cfg)
    engine = demo.engine
    process = type(engine).process_pair.__get__(engine)

    def process_and_snapshot(*args, **kw):
        out = process(*args, **kw)
        demo.snapshots.append(int(out[1].count))
        return out

    engine.process_pair = process_and_snapshot
    return demo.run(verbose=False)


@pytest.fixture(scope="module")
def demos():
    from e2eslam_tpu_torch.apps.demo import Demo
    from test_torch_apps import _model, tiny

    jax_result = _jax_demo_counts(jax_tiny())
    cfg = tiny()
    demo = Demo(cfg, model=_model(cfg))
    return demo, demo.run(verbose=False), jax_result


def test_demo_snapshots_match_jax_counts(demos, tmp_path):
    demo, result, want = demos
    got = [s.count for s in result["snapshots"]]
    counts = want["snapshots"]
    assert len(got) == len(counts) == result["num_keyframes"] == want["num_keyframes"] >= 3
    for g, w in zip(got, counts):
        assert abs(g - w) <= max(4, w // 100), (got, counts)
    assert got == sorted(got) and got[-1] == result["map_points"]
    assert all(s.data.device.type == "cpu" and s.data.shape[0] == s.count
               for s in result["snapshots"])
    paths = demo.export_snapshots(str(tmp_path), max_points=500)
    assert len(paths) == len(got)
    html = demo.export_animation(result, str(tmp_path / "map_update.html"), max_points=300)
    from e2eslam_tpu_torch.viz.animation import read_animation_html

    fig = read_animation_html(html)
    assert len(fig["frames"]) == len(got)
    for i, frame in enumerate(fig["frames"]):
        frustum, center, traj, cloud = frame["data"]
        assert len(frustum["x"]) == 10 and len(traj["x"]) == i + 1
        assert 0 < len(cloud["x"]) <= 300
    np.testing.assert_allclose(result["intrinsics"], np.asarray(want["intrinsics"]))
