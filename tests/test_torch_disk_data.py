"""The port's ICL-NUIM and TUM loaders against the JAX package's.

The same sequence through both, decoded the same way (the native loader on
both sides, or PIL on both sides: each side's result is exact), must give
equal windows: colours, depths, intrinsics, poses and transforms. Across
decoders (native against PIL) colours agree to 1.0 and depths to 1e-4, the
JAX package's own tolerances (tests/test_disk_datasets.py:122-125). The
data: the repository's 10-frame ICL-format sequence
(``tests/data/ICL/living_room_traj0_frei_png``, 640x480) and TUM-format
sequences written to ``tmp_path`` (depth frames 5 ms and poses 2 ms off the
colour frames, a comment line in the ground truth).
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import os
import threading

import numpy as np
import pytest

import e2eslam_tpu.data.native_loader as jax_native
from e2eslam_tpu.data.tumicl import ICLDataset as JaxICL
from e2eslam_tpu.data.tumicl import TUMDataset as JaxTUM
from e2eslam_tpu_torch.data import native_loader
from e2eslam_tpu_torch.data.tumicl import ICLDataset, TUMDataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI_ICL = os.path.join(ROOT, "tests", "data", "ICL")


def _write_png(path, arr):
    """uint8 [H, W, 3] as an RGB PNG, uint16 [H, W] as a 16-bit grey one."""
    from PIL import Image

    Image.fromarray(arr).save(path)


def make_tum(root, n_frames=6, H=48, W=64, seed=1):
    """A TUM-format sequence: colour frames 0.1 s apart, each depth frame
    5 ms after its colour frame, each pose 2 ms after; a colour frame with
    no depth frame within 20 ms (dropped) and a pose far from every frame."""
    seq = os.path.join(root, "rgbd_dataset_freiburg1_test")
    os.makedirs(os.path.join(seq, "rgb"))
    os.makedirs(os.path.join(seq, "depth"))
    rng = np.random.default_rng(seed)
    with open(os.path.join(seq, "rgb.txt"), "w") as fr, \
            open(os.path.join(seq, "depth.txt"), "w") as fd, \
            open(os.path.join(seq, "groundtruth.txt"), "w") as fg:
        fr.write("# color images\n")
        fg.write("# ground truth trajectory\n# timestamp tx ty tz qx qy qz qw\n")
        for i in range(n_frames):
            t = 100.0 + i * 0.1
            _write_png(os.path.join(seq, "rgb", f"{t:.4f}.png"),
                       rng.integers(0, 255, (H, W, 3), np.uint8))
            _write_png(os.path.join(seq, "depth", f"{t:.4f}.png"),
                       rng.integers(500, 20000, (H, W), np.uint16))
            fr.write(f"{t:.4f} rgb/{t:.4f}.png\n")
            if i != 3:  # frame 3 has no depth frame: dropped
                fd.write(f"{t + 0.005:.4f} depth/{t:.4f}.png\n")
            q = rng.normal(size=4)
            fg.write(f"{t + 0.002:.4f} {0.05 * i} {0.01 * i} 0 {q[0]} {q[1]} {q[2]} {q[3]}\n")
        fg.write("250.0 9 9 9 0 0 0 1\n")
    return seq


def _pair(cls_port, cls_jax, decoder, monkeypatch, **kw):
    """The port's dataset with ``decoder`` and the JAX package's with the
    same one (``pil``: its native loader stubbed out)."""
    if decoder == "pil":
        monkeypatch.setattr(jax_native, "load_rgbd_batch", lambda *a, **k: None)
    elif not (jax_native.native_available() and native_loader.native_available()):
        pytest.skip("the native loader does not build here")
    return cls_port(decoder=decoder, **kw), cls_jax(**kw)


def _assert_windows_equal(port, jax_ds):
    assert len(port) == len(jax_ds) > 0
    assert port.windows == jax_ds.windows
    for i in range(len(port)):
        for a, b, name in zip(port[i], jax_ds[i], ("colors", "depths", "K", "poses", "T")):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=f"window {i} {name}")


@pytest.mark.parametrize("decoder", ["native", "pil"])
@pytest.mark.parametrize("hw", [(64, 96), (256, 320)])
def test_icl_windows_equal_jax(decoder, hw, monkeypatch):
    H, W = hw
    kw = dict(basedir=MINI_ICL, seqlen=3, height=H, width=W, dilation=1, stride=2)
    port, jax_ds = _pair(ICLDataset, JaxICL, decoder, monkeypatch, **kw)
    assert port.decoder == decoder
    _assert_windows_equal(port, jax_ds)
    K = port.intrinsics
    assert K[0, 0] == pytest.approx(481.20 * W / 640, rel=1e-6)
    assert K[1, 1] == pytest.approx(-480.0 * H / 480, rel=1e-6)  # ICL's negative fy


@pytest.mark.parametrize("decoder", ["native", "pil"])
def test_tum_association_equals_jax(decoder, tmp_path, monkeypatch):
    make_tum(str(tmp_path))
    kw = dict(basedir=str(tmp_path), seqlen=2, height=48, width=64)
    port, jax_ds = _pair(TUMDataset, JaxTUM, decoder, monkeypatch, **kw)
    assert port.rgb_files == jax_ds.rgb_files and port.depth_files == jax_ds.depth_files
    assert len(port.rgb_files) == 5  # frame 3 dropped
    assert not any("100.3000" in f for f in port.rgb_files)
    _assert_windows_equal(port, jax_ds)
    assert port[1][3][1][0, 3] == pytest.approx(0.1, abs=1e-6)  # poses by timestamp
    assert port.intrinsics[0, 0] == pytest.approx(525.0)


def test_native_matches_pil():
    """At the native size (no resize) colours to 1.0 and depths to 1e-4, as
    the JAX test holds them. Resized, depths (nearest) still agree; colours
    do not: PIL's bilinear filter widens its support when it shrinks (an
    antialiased resize), the native loader samples four pixels (up to 32
    grey levels apart at 64x96)."""
    if not native_loader.native_available():
        pytest.skip("the native loader does not build here")
    for H, W in ((480, 640), (64, 96)):
        nat = ICLDataset(MINI_ICL, seqlen=2, height=H, width=W, decoder="native")
        pil = ICLDataset(MINI_ICL, seqlen=2, height=H, width=W, decoder="pil")
        for i in (0, 4, 8):
            a, b = nat[i], pil[i]
            if (H, W) == (480, 640):
                np.testing.assert_allclose(a[0], b[0], atol=1.0, rtol=0)
            np.testing.assert_allclose(a[1], b[1], atol=1e-4, rtol=0)
            for x, y in zip(a[2:], b[2:]):
                np.testing.assert_array_equal(x, y)


def test_make_dataset_icl_tum_and_trajectories(tmp_path):
    import shutil

    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.data.pipeline import make_dataset

    icl = tmp_path / "ICL"
    shutil.copytree(os.path.join(MINI_ICL, "living_room_traj0_frei_png"),
                    icl / "living_room_traj0_frei_png")
    shutil.copytree(os.path.join(MINI_ICL, "living_room_traj0_frei_png"),
                    icl / "living_room_traj2_frei_png")
    make_tum(str(tmp_path / "TUM"))
    cfg = load_yaml(default_config_path())
    cfg.DATA.data_path = str(tmp_path)
    cfg.DATA.height, cfg.DATA.width = 48, 64
    cfg.DATA.start, cfg.DATA.dilation, cfg.DATA.stride = 0, 0, 1
    cfg.DEMO.sequence_length = 2
    cfg.DATA.name = "ICL"
    cfg.DATA.trajectories = "living_room_traj2_frei_png"
    ds = make_dataset(cfg)
    assert [os.path.basename(t) for t in ds.traj_dirs] == ["living_room_traj2_frei_png"]
    cfg.DATA.trajectories = None
    assert len(make_dataset(cfg).traj_dirs) == 2
    cfg.DATA.name = "TUM"
    ds = make_dataset(cfg)
    assert isinstance(ds, TUMDataset) and len(ds) == 4
    cfg.DATA.name = "KITTI"
    with pytest.raises(ValueError, match="unknown dataset"):
        make_dataset(cfg)


def test_frame_cache_concurrent_access():
    """Four threads over one dataset whose cache holds 4 frames: every call
    evicts, and each returns its window's frames."""
    ds = ICLDataset(MINI_ICL, seqlen=4, height=24, width=32, stride=1)
    ds._CACHE_FRAMES = 4
    expected = [ds[i] for i in range(len(ds))]
    ds._frame_cache.clear()
    errors = []

    def worker(offset):
        try:
            for _ in range(3):
                for i in range(len(ds)):
                    j = (i + offset) % len(ds)
                    colors, depths = ds._decoded_frames(ds.windows[j])
                    np.testing.assert_array_equal(colors, expected[j][0])
                    np.testing.assert_array_equal(depths, expected[j][1])
        except Exception as exc:  # noqa: BLE001 - collected for the assert
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors


def test_native_library_lives_in_the_port_build_dir():
    if not native_loader.native_available():
        pytest.skip("the native loader does not build here")
    path = native_loader.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "e2eslam_tpu_torch", "data", "build")
    assert os.path.exists(path)
    # Only the JAX package's own build may sit in native/, under its own name.
    stray = [f for f in os.listdir(os.path.join(ROOT, "native"))
             if f.endswith(".so") and f != "librgbd_loader.so"]
    assert not stray, stray


def test_no_decoder_raises_with_both_causes(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name.startswith("PIL"):
            raise ImportError("no module named PIL (test)")
        return real_import(name, *a, **k)

    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_error", "g++ failed (test)")
    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match=r"native: g\+\+ failed \(test\).*pil: no module"):
        ICLDataset(MINI_ICL, seqlen=2, height=24, width=32)
