"""The port stands alone: no module of ``e2eslam_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the entry points run
on CUDA unless asked for the CPU -- without a card they raise."""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import ast
import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "e2eslam_tpu")


def _port_modules():
    import e2eslam_tpu_torch

    return sorted(m.name for m in pkgutil.walk_packages(e2eslam_tpu_torch.__path__,
                                                        "e2eslam_tpu_torch."))


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert "e2eslam_tpu_torch.ops.knn" in mods and "e2eslam_tpu_torch.apps.online_adaption" in mods
    assert {"e2eslam_tpu_torch.checkpoint", "e2eslam_tpu_torch.data.tumicl",
            "e2eslam_tpu_torch.data.native_loader", "e2eslam_tpu_torch.slam.compact"} <= set(mods)
    code = textwrap.dedent(f"""
        import importlib, sys
        for m in {mods!r}:
            importlib.import_module(m)
        bad = sorted(k for k in sys.modules
                     if k.split('.')[0] in {FORBIDDEN!r})
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", ["chip_smoke.py", "e2eslam_tpu_torch"])
def test_sources_name_no_jax(path):
    """Static check of every import statement (also those inside functions)."""
    files = [os.path.join(ROOT, path)]
    if os.path.isdir(files[0]):
        files = [os.path.join(d, f) for d, _, fs in os.walk(files[0])
                 for f in fs if f.endswith(".py")]
    for f in files:
        with open(f) as fh:
            tree = ast.parse(fh.read(), f)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (f, n)


def test_native_loader_builds_only_into_the_port():
    """The port compiles the shared ``native/rgbd_loader.cpp`` into its own
    git-ignored ``data/build/`` and never loads the JAX package's
    ``native/librgbd_loader.so``."""
    from e2eslam_tpu_torch.data import native_loader

    assert native_loader.SOURCE == os.path.join(ROOT, "native", "rgbd_loader.cpp")
    assert native_loader.BUILD_DIR == os.path.join(ROOT, "e2eslam_tpu_torch", "data", "build")
    assert native_loader.library_path().startswith(native_loader.BUILD_DIR + os.sep)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "e2eslam_tpu_torch/data/build/" in f.read().split()


def test_cuda_is_the_default_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot be shown here")
    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.device import resolve_device
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    cfg = load_yaml(default_config_path())
    assert cfg.SETTINGS.device == "tpu"  # the shipped config: CUDA in the port
    for device in (None, "cuda", "tpu"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(device)
    with pytest.raises(RuntimeError, match="CUDA"):
        OnlineAdaptation(cfg)
    assert resolve_device("cpu").type == "cpu"
    cfg.SETTINGS.device = "cpu"
    assert resolve_device(None, cfg).type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    out = subprocess.run([sys.executable, str(lone)], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
