"""The port's weight loading and checkpoints against the JAX package's.

Reference-layout files are written from seeded weights: the indoor
network's ``depth.pth.tar`` (``{"state_dict": ...}`` with the ``module.``
prefix, the nested ``encoder.encoder.`` / ``decoder.decoder.`` keys and
batch-norm step counters), monodepth2's per-module ``depth_encoder.pth``
(with its ``height``/``width``/``use_stereo`` entries) and
``depth_decoder.pth``, and a bare torchvision ImageNet state dict. The same
files go through ``e2eslam_tpu.models.convert.load_depth_weights`` and the
port's ``load_depth_weights``, each network starting from the JAX package's
initialisation: the loaded entries equal the file's bit for bit, and the
disparities agree to the CNN tolerance of tests/test_torch_models.py (1e-4
relative, 1e-5 absolute).
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import functools
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2eslam_tpu.config import default_config_path as jax_default_path
from e2eslam_tpu.config import load_yaml as jax_load_yaml
from e2eslam_tpu.models.convert import load_depth_weights as jax_load_depth_weights
from e2eslam_tpu.models.depth_net import init_depth_model
from e2eslam_tpu.models.depth_net import make_depth_model as jax_model
from e2eslam_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.engine.optim import make_optimizer
from e2eslam_tpu_torch.models.convert import load_depth_weights, load_jax_params
from e2eslam_tpu_torch.models.depth_net import make_depth_model

H = W = 64


def _cfgs(network, **model):
    out = []
    for load, path in ((jax_load_yaml, jax_default_path()), (load_yaml, default_config_path())):
        cfg = load(path)
        cfg.DATA.height, cfg.DATA.width = H, W
        cfg.MODEL.depth_network = network
        cfg.MODEL.update(model)
        out.append(cfg)
    return out


def seeded_state_dict(network: str, seed: int = 7):
    """A state dict of the port's network from ``seed``: the seeded
    initialisation's convolution kernels, with batch-norm scales, biases,
    means and variances and the convolutions' biases drawn from a numpy
    seed (non-trivial, of a trained network's order)."""
    cfg = load_yaml(default_config_path())
    cfg.MODEL.depth_network = network
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in make_depth_model(cfg, seed=seed).state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if v.dim() == 1:
            x = rng.normal(0.0, 0.05, v.shape)
            if k.endswith("running_var") or (k.endswith(".weight") and "bn" in k):
                x = rng.uniform(0.8, 1.2, v.shape)
            v = torch.from_numpy(x.astype(np.float32))
        out[k] = v.clone()
    return out


def write_indoor(dirpath, sd, drop=()):
    """The reference's ``depth.pth.tar``: a DataParallel-wrapped
    DispResNet_Indoor's state dict under ``state_dict``."""
    ref = {}
    for k, v in sd.items():
        if k in drop:
            continue
        part, rest = k.split(".", 1)
        ref[f"module.{part}.{part}.{rest}"] = v
        if rest.endswith("running_var"):
            ref[f"module.{part}.{part}.{rest[:-len('running_var')]}num_batches_tracked"] = \
                torch.tensor(11)
    os.makedirs(dirpath, exist_ok=True)
    torch.save({"epoch": 4, "state_dict": ref}, os.path.join(dirpath, "depth.pth.tar"))


def write_monodepth2(dirpath, sd, names=("depth_encoder", "depth_decoder")):
    enc = {k: v for k, v in sd.items() if k.startswith("encoder.")}
    enc.update(height=192, width=640, use_stereo=False)
    dec = {k: v for k, v in sd.items() if k.startswith("decoder.")}
    os.makedirs(dirpath, exist_ok=True)
    torch.save(enc, os.path.join(dirpath, f"{names[0]}.pth"))
    torch.save(dec, os.path.join(dirpath, f"{names[1]}.pth"))


@functools.lru_cache(maxsize=None)
def _jax_network(network):
    """The JAX package's network, its initial weights (numpy) and its
    compiled forward, made once per network for the module."""
    jm = jax_model(_cfgs(network)[0])
    params, stats = init_depth_model(jm, jax.random.key(0), H, W)
    weights = jax.tree_util.tree_map(np.asarray, (params, stats))
    return weights, jax.jit(lambda v, x: jm.apply(v, x, train=False)[0])


def _both(network, **model):
    """(JAX disparity, port disparity, port network) after each package's
    ``load_depth_weights``, both from the JAX package's initialisation."""
    jcfg, cfg = _cfgs(network, **model)
    (params, stats), apply = _jax_network(network)
    net = make_depth_model(cfg)
    load_jax_params(net, params, stats)
    params, stats = jax_load_depth_weights(jcfg, params, stats)
    load_depth_weights(cfg, net)
    x = np.random.default_rng(1).uniform(size=(2, H, W, 3)).astype(np.float32)
    want = apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    return np.asarray(want), got.numpy(), net


def _assert_loaded(net, sd, keys):
    own = net.state_dict()
    for k in keys:
        assert torch.equal(own[k], sd[k]), k


def test_indoor_depth_pth_tar(tmp_path):
    sd = seeded_state_dict("indoor")
    write_indoor(str(tmp_path), sd)
    want, got, net = _both("indoor", use_pretrained_models=True, load_depth_path=str(tmp_path))
    _assert_loaded(net, sd, sd)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_monodepth2_modules(tmp_path):
    sd = seeded_state_dict("monodepth2")
    write_monodepth2(str(tmp_path), sd)
    want, got, net = _both("monodepth2", use_pretrained_models=True,
                           load_depth_path=str(tmp_path))
    _assert_loaded(net, sd, sd)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # MODEL.models_to_load wins over pretrained_models_list.
    write_monodepth2(str(tmp_path / "release"), seeded_state_dict("monodepth2", 8),
                     names=("encoder", "depth"))
    _, cfg = _cfgs("monodepth2", use_pretrained_models=True,
                   load_depth_path=str(tmp_path / "release"), models_to_load=["encoder", "depth"])
    load_depth_weights(cfg, net)
    _assert_loaded(net, seeded_state_dict("monodepth2", 8), sd)


def test_imagenet_encoder_then_task_checkpoint(tmp_path):
    """A bare torchvision state dict (with its ``fc`` head) initialises the
    encoder, the decoder keeps its initialisation; a task checkpoint then
    overrides everything."""
    sd = seeded_state_dict("indoor", seed=9)
    tv = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    tv.update({"fc.weight": torch.zeros(1000, 512), "fc.bias": torch.zeros(1000)})
    path = str(tmp_path / "resnet18.pth")
    torch.save(tv, path)
    want, got, net = _both("indoor", weights_init_encoder="imagenet", imagenet_weights_path=path)
    _assert_loaded(net, sd, [k for k in sd if k.startswith("encoder.")])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    task = seeded_state_dict("indoor", seed=10)
    write_indoor(str(tmp_path / "task"), task)
    want, got, net = _both("indoor", weights_init_encoder="imagenet", imagenet_weights_path=path,
                           use_pretrained_models=True, load_depth_path=str(tmp_path / "task"))
    _assert_loaded(net, task, task)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    _, cfg = _cfgs("indoor", weights_init_encoder="imagenet")
    with pytest.raises(ValueError, match="imagenet_weights_path"):
        load_depth_weights(cfg, net)


def test_load_warnings(tmp_path):
    _, cfg = _cfgs("monodepth2", use_pretrained_models=True, load_depth_path=str(tmp_path),
                   models_to_load=["junk"])
    torch.save({"head.weight": torch.zeros(3)}, str(tmp_path / "junk.pth"))
    net = make_depth_model(cfg)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    with pytest.warns(UserWarning, match="matched 0 model leaves"):
        load_depth_weights(cfg, net)
    assert all(torch.equal(before[k], v) for k, v in net.state_dict().items())

    sd = seeded_state_dict("indoor")
    missing = ["decoder.13.conv.bias", "encoder.layer4.1.bn2.running_var"]
    write_indoor(str(tmp_path / "partial"), sd, drop=missing)
    _, cfg = _cfgs("indoor", use_pretrained_models=True, load_depth_path=str(tmp_path / "partial"))
    net = make_depth_model(cfg)
    with pytest.warns(UserWarning, match="left 2 leaves at initialization"):
        load_depth_weights(cfg, net)
    _assert_loaded(net, sd, [k for k in sd if k not in missing])
    write_indoor(str(tmp_path / "full"), sd)
    _, cfg = _cfgs("indoor", use_pretrained_models=True, load_depth_path=str(tmp_path / "full"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        load_depth_weights(cfg, net)


def _trained(seed=0):
    """A network and its Adam after two steps (non-empty optimizer state)."""
    cfg = load_yaml(default_config_path())
    net = make_depth_model(cfg, seed=seed)
    opt, _ = make_optimizer(cfg, net.parameters())
    x = torch.from_numpy(np.random.default_rng(seed).uniform(size=(1, H, W, 3)).astype(np.float32))
    for _ in range(2):
        opt.zero_grad()
        net(x).mean().backward()
        opt.step()
    return cfg, net, opt


def test_checkpoint_round_trip(tmp_path):
    cfg, net, opt = _trained()
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, net, opt, meta={"keyframes": 3, "refine_steps": 9})
    fresh = make_depth_model(cfg, seed=5)
    fresh_opt, _ = make_optimizer(cfg, fresh.parameters())
    meta = load_checkpoint(path, fresh, fresh_opt)
    assert meta == {"keyframes": 3, "refine_steps": 9}
    for (k, a), b in zip(net.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = opt.state_dict(), fresh_opt.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb["state"][i][k])), (i, k)
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["files"] == ["model.pt", "optimizer.pt"]


def test_checkpoint_stale_files_and_missing_manifest(tmp_path):
    cfg, net, opt = _trained()
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, net, opt)
    save_checkpoint(path, net)  # optimizer.pt stays on disk, unrecorded
    assert os.path.exists(os.path.join(path, "optimizer.pt"))
    fresh_opt, _ = make_optimizer(cfg, make_depth_model(cfg).parameters())
    load_checkpoint(path, make_depth_model(cfg), fresh_opt)
    assert not fresh_opt.state_dict()["state"]  # the stale state was not restored
    os.remove(os.path.join(path, "manifest.json"))  # a save cut short
    with pytest.raises(FileNotFoundError):
        load_checkpoint(path, make_depth_model(cfg))


def test_jax_msgpack_checkpoint_is_refused(tmp_path):
    """A JAX package checkpoint directory (flax msgpack files) was once
    refused; ``load_checkpoint`` now reads it: every parameter and
    statistic equal to the bit, the disparity the JAX network's to the CNN
    tolerance (1e-4 relative, 1e-5 absolute), the manifest's meta
    returned."""
    from e2eslam_tpu.checkpoint import save_checkpoint as jax_save
    from e2eslam_tpu_torch.models.convert import from_jax_params

    (params, stats), apply = _jax_network("indoor")
    jax_save(str(tmp_path), params, stats, meta={"keyframes": 4})
    net = make_depth_model(_cfgs("indoor")[1], seed=3)
    assert load_checkpoint(str(tmp_path), net) == {"keyframes": 4}
    own = net.state_dict()
    for k, v in from_jax_params(params, stats).items():
        assert torch.equal(own[k], v), k
    x = np.random.default_rng(1).uniform(size=(2, H, W, 3)).astype(np.float32)
    want = np.asarray(apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _grads(tree):
    """A deterministic gradient per leaf (numpy)."""
    return jax.tree_util.tree_map(lambda p: np.sin(7.0 * np.asarray(p) + 1.0), tree)


def test_jax_adam_state_resumes_in_torch_adam(tmp_path):
    """JAX ``save_checkpoint`` of params, batch stats and an optax Adam state
    after two updates -> the port's ``load_checkpoint`` into a network and
    torch's Adam: one more step on the same gradients equals optax's next
    step (1e-6 relative, as tests/test_torch_optim.py holds the two
    Adams); the restored moments and step count equal optax's to the bit."""
    import optax

    from e2eslam_tpu.checkpoint import save_checkpoint as jax_save
    from e2eslam_tpu_torch.models.convert import from_jax_params

    (params, stats), _ = _jax_network("indoor")
    tx = optax.adam(1e-2)
    opt_state = tx.init(params)
    p = params
    for _ in range(2):
        updates, opt_state = tx.update(_grads(p), opt_state, p)
        p = optax.apply_updates(p, updates)
    p = jax.tree_util.tree_map(np.asarray, p)
    jax_save(str(tmp_path), p, stats, opt_state)
    updates, _ = tx.update(_grads(p), opt_state, p)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, optax.apply_updates(p, updates)),
                           stats)

    cfg = _cfgs("indoor")[1]
    cfg.OPTIMIZATION.learning_rate = 1e-2
    cfg.OPTIMIZATION.schedular = None
    net = make_depth_model(cfg)
    opt, _ = make_optimizer(cfg, net.parameters())
    load_checkpoint(str(tmp_path), net, opt)
    mu = from_jax_params(jax.tree_util.tree_map(np.asarray, opt_state[0].mu), {})
    named = dict(net.named_parameters())
    for k, m in mu.items():
        st = opt.state[named[k]]
        assert float(st["step"]) == 2.0
        assert torch.equal(st["exp_avg"], m), k
    grads = from_jax_params(_grads(p), {})
    for k, t in named.items():
        t.grad = grads[k].clone()
    opt.step()
    for k, t in named.items():
        w = want[k].numpy()
        np.testing.assert_allclose(t.detach().numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


def test_jax_checkpoint_rules(tmp_path):
    """The JAX package's manifest rules: a missing manifest raises; a file
    the manifest does not record is not read; an optimizer state other
    than optax Adam's is refused, naming what it holds."""
    import optax

    from e2eslam_tpu.checkpoint import save_checkpoint as jax_save

    (params, stats), _ = _jax_network("indoor")
    cfg = _cfgs("indoor")[1]
    sgd = optax.chain(optax.add_decayed_weights(1e-3), optax.sgd(1e-2, momentum=0.9))
    path = str(tmp_path / "sgd")
    jax_save(path, params, stats, sgd.init(params))
    net = make_depth_model(cfg)
    opt, _ = make_optimizer(cfg, net.parameters())
    with pytest.raises(ValueError, match="trace"):
        load_checkpoint(path, net, opt)
    load_checkpoint(path, make_depth_model(cfg))  # without an optimizer: the weights only
    # A later save without batch stats: the stale file on disk is not read.
    jax_save(path, params)
    net = make_depth_model(cfg, seed=4)
    before = {k: v.clone() for k, v in net.state_dict().items() if "running" in k}
    load_checkpoint(path, net)
    for k, v in before.items():
        assert torch.equal(net.state_dict()[k], v), k
    os.remove(os.path.join(path, "manifest.json"))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(path, make_depth_model(cfg))


def test_online_adaptation_restores_a_jax_checkpoint(tmp_path):
    """``MODEL.restore_checkpoint`` naming a JAX package directory: the
    runner's network starts from its weights."""
    from e2eslam_tpu.checkpoint import save_checkpoint as jax_save
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation
    from e2eslam_tpu_torch.models.convert import from_jax_params

    (params, stats), _ = _jax_network("indoor")
    jax_save(str(tmp_path), params, stats)
    cfg = _cfgs("indoor")[1]
    cfg.MODEL.restore_checkpoint = str(tmp_path)
    runner = OnlineAdaptation(cfg, device="cpu", model=make_depth_model(cfg, seed=9))
    own = runner.engine.model.state_dict()
    for k, v in from_jax_params(params, stats).items():
        assert torch.equal(own[k], v), k


def test_msgpack_decoder_matches_msgpack():
    """The port's decoder against the ``msgpack`` package's encoder on every
    wire type a flax file can hold, and flax's arrays (bfloat16 included)."""
    import msgpack
    from flax import serialization

    from e2eslam_tpu_torch.checkpoint import msgpack_decode

    values = [None, True, False, 0, 127, 128, 255, 65535, 2**32, 2**64 - 1, -1, -32, -33,
              -129, -2**31 - 1, -2**63, 1.5, -0.25, "", "a" * 31, "b" * 40, "c" * 300,
              "d" * 70000, b"", b"x" * 300, b"y" * 70000, [1] * 15, [2] * 16, [3] * 70000,
              {f"k{i}": i for i in range(15)}, {f"k{i}": i for i in range(16)},
              {f"k{i}": i for i in range(70000)}, {"nested": {"list": [1, "two", None]}}]
    for v in values:
        assert msgpack_decode(msgpack.packb(v, use_bin_type=True)) == v
    tree = {"f32": np.arange(6, dtype=np.float32).reshape(2, 3),
            "bf16": np.asarray(jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16)),
            "i32": np.array([[1, -2]], np.int32), "scalar": np.float32(2.5),
            "empty": np.zeros((0, 3), np.float32)}
    got = msgpack_decode(serialization.msgpack_serialize(tree))
    for k, v in tree.items():
        want = torch.from_numpy(np.asarray(v, np.float32)) if k == "bf16" else \
            torch.from_numpy(np.asarray(v))
        assert tuple(got[k].shape) == np.shape(v), k
        assert torch.equal(got[k].float(), want.float()), k
    assert got["bf16"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        msgpack_decode(msgpack.packb([1, 2]) + b"\x00")
