"""Parity of the port's ``DispResNetIndoor`` with the flax model, through the
weight bridge ``models/convert.py::from_jax_params``.

Tolerance: the disparity is ``10 * sigmoid(x) + 0.01`` after ~20 float32
convolutions whose sums run in another order (XLA's vs oneDNN's conv
algorithms): 1e-4 relative, 1e-5 absolute. TF32 plays no part on the CPU
(the entry points switch it off on CUDA, ``device.set_full_fp32``).
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2eslam_tpu.models.convert import _torch_key
from e2eslam_tpu.models.depth_net import DispResNetIndoor as JaxIndoor
from e2eslam_tpu.models.depth_net import init_depth_model
from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.models.convert import from_jax_params, load_jax_params, torch_key
from e2eslam_tpu_torch.models.depth_net import DispResNetIndoor, make_depth_model

H = W = 64


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def jax_indoor():
    model = JaxIndoor(num_layers=18)
    params, stats = init_depth_model(model, jax.random.key(0), H, W)
    # Non-trivial batch-norm statistics, so the bridge's mean/var mapping
    # is exercised (flax initialises them to 0/1).
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.uniform(0.0, 0.2, x.shape).astype(np.float32), stats)
    params = jax.tree_util.tree_map(np.asarray, params)
    return model, params, stats


def test_state_dict_keys_are_the_reference_torch_keys(jax_indoor):
    _, params, stats = jax_indoor
    want = {_torch_key(p, "params") for p, _ in _flat(params)}
    want |= {_torch_key(p, "batch_stats") for p, _ in _flat(stats)}
    port = DispResNetIndoor(18)
    keys = {k for k in port.state_dict() if not k.endswith("num_batches_tracked")}
    assert keys == want
    assert {torch_key(p, "params") for p, _ in _flat(params)} == {
        _torch_key(p, "params") for p, _ in _flat(params)}
    assert "encoder.layer1.0.conv1.weight" in keys
    assert "decoder.0.conv.conv.weight" in keys and "decoder.13.conv.bias" in keys


def test_disparity_matches_flax(jax_indoor):
    model, params, stats = jax_indoor
    port = DispResNetIndoor(18)
    load_jax_params(port, params, stats)
    x = np.random.default_rng(1).uniform(size=(2, H, W, 3)).astype(np.float32)
    want = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                       train=False)[0]
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, H, W, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_bridge_layouts(jax_indoor):
    _, params, stats = jax_indoor
    sd = from_jax_params(params, stats)
    k = np.asarray(params["encoder"]["conv1"]["kernel"])  # HWIO
    np.testing.assert_array_equal(sd["encoder.conv1.weight"].numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["encoder.bn1.running_var"].numpy(),
                                  np.asarray(stats["encoder"]["bn1"]["var"]))


@pytest.mark.parametrize("layers", [18, 34, 50])
def test_resnet_depths_keys(layers):
    """Every flax leaf of the 18/34/50 models has its port counterpart."""
    shapes = jax.eval_shape(
        lambda: JaxIndoor(num_layers=layers).init(jax.random.key(0),
                                                  jnp.zeros((1, H, W, 3)), train=False))
    port = DispResNetIndoor(layers).state_dict()
    for coll in ("params", "batch_stats"):
        for path, leaf in _flat(shapes[coll]):
            t = port[_torch_key(path, coll)]
            shape = tuple(leaf.shape)
            if path[-1] == "kernel":
                shape = (shape[3], shape[2], shape[0], shape[1])
            assert tuple(t.shape) == shape, path


def test_seeded_init_follows_flax_distributions():
    cfg = load_yaml(default_config_path())
    a, b = make_depth_model(cfg, seed=0), make_depth_model(cfg, seed=0)
    a.requires_grad_(False)
    for (ka, va), (_, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(va, vb), ka
    w = a.encoder.layer3[0].conv1.weight.detach()  # 3x3x128 -> 256: lecun_normal
    std = float(w.std())
    assert abs(std - (1.0 / (128 * 9)) ** 0.5) < 0.05 * std
    assert float(w.abs().max()) <= 2.0 * (1.0 / (128 * 9)) ** 0.5 / 0.8796 + 1e-6
    assert float(a.decoder[0].conv.conv.bias.abs().max()) == 0.0
    assert float(a.encoder.bn1.weight.min()) == 1.0 and float(a.encoder.bn1.running_var.min()) == 1.0
    assert not a.training and not a.train().training  # batch norm stays frozen
