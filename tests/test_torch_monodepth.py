"""Parity of the port's ``MonodepthNet`` (``MODEL.depth_network:
monodepth2``) with the flax model, through the weight bridge.

Tolerance: the indoor network's (tests/test_torch_models.py), 1e-4
relative / 1e-5 absolute on sigmoid disparities after ~20 (ResNet-18) or
~70 (ResNet-50) float32 convolutions summed in another order.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2eslam_tpu.models.depth_net import MonodepthNet as JaxMonodepth
from e2eslam_tpu.models.depth_net import init_depth_model
from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.models.convert import from_jax_params, load_jax_params
from e2eslam_tpu_torch.models.decoders import DepthDecoder
from e2eslam_tpu_torch.models.depth_net import MonodepthNet, make_depth_model

H, W = 64, 96


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module", params=[18, 50])
def jax_monodepth(request):
    model = JaxMonodepth(num_layers=request.param, scales=(0, 1, 2, 3))
    params, stats = init_depth_model(model, jax.random.key(3), H, W)
    return request.param, model, _np(params), _np(stats)


def test_monodepth_forward_matches_flax(jax_monodepth):
    """ResNet-18, and ResNet-50's bottleneck blocks and 4x-wide skips."""
    layers, model, params, stats = jax_monodepth
    port = MonodepthNet(layers, (0, 1, 2, 3))
    load_jax_params(port, params, stats)
    x = np.random.default_rng(1).uniform(size=(2, H, W, 3)).astype(np.float32)
    want = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port.decoder(port.encoder(torch.from_numpy(x).permute(0, 3, 1, 2)))
        scale0 = port(torch.from_numpy(x))
    assert sorted(got) == [0, 1, 2, 3]
    for s in range(4):
        d = got[s].permute(0, 2, 3, 1)
        assert d.shape == (2, H >> s, W >> s, 1)
        np.testing.assert_allclose(d.numpy(), np.asarray(want[s]), rtol=1e-4, atol=1e-5,
                                   err_msg=f"scale {s}")
    assert torch.equal(scale0, got[0].permute(0, 2, 3, 1))
    assert 0.0 < float(scale0.min()) and float(scale0.max()) < 1.0  # sigmoid


def test_make_depth_model_monodepth2_has_the_flax_keys():
    """The default ``DATA.scales: [0]``: one disparity head, and every flax
    leaf maps onto a parameter of the port's model."""
    cfg = load_yaml(default_config_path())
    cfg.MODEL.depth_network = "monodepth2"
    port = make_depth_model(cfg)
    assert isinstance(port, MonodepthNet) and len(port.decoder) == 11
    shapes = jax.eval_shape(lambda: JaxMonodepth(num_layers=18, scales=(0,)).init(
        jax.random.key(0), jnp.zeros((1, H, W, 3)), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = from_jax_params(zeros["params"], zeros["batch_stats"])
    got = {k: v for k, v in port.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k


def test_depth_decoder_needs_scales_from_zero():
    with pytest.raises(ValueError):
        DepthDecoder((64, 64, 128, 256, 512), scales=(0, 2))
