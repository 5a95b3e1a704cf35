"""The port's optimizers and schedules against the JAX package's optax ones.

Every ``OPTIMIZATION.optimizer`` (Adam, SGD, RMSprop, Adagrad) with every
``schedular`` (none, StepLR, MultiStepLR with a repeated milestone,
ExponentialLR), per tensor and with ``fused_update``: the same parameter
tree (seeded from numpy) takes the same 30 gradients, across the
schedules' boundaries, through ``e2eslam_tpu.engine.optim.make_optimizer``
and the port's ``make_optimizer``. Parameters agree to 1e-6 relative (the
formulas are the same; the two packages round a few operations in other
orders). The learning rate, 1e-2, moves the parameters far past that.
SGD, RMSprop and Adagrad are the port's own (``engine/optim.py``), Adam
torch's.

Also: ``chip_smoke.optax_reference``, the float64 numpy transcription of
optax's Adam and SGD that the card's checks hold the optimizers against
(``chip_smoke.py``'s ``optimizers`` phase, tests/test_torch_cuda.py, where
no JAX is installed), against optax itself run in float64, at 1e-7; so
the card's check closes on optax.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from e2eslam_tpu.config import default_config_path as jax_default_path
from e2eslam_tpu.config import load_yaml as jax_load_yaml
from e2eslam_tpu.engine.optim import make_optimizer as jax_make_optimizer
from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.engine.optim import make_optimizer

STEPS = 30
SHAPES = {"conv": (4, 3, 3, 3), "bias": (4,), "bn": (7,), "fc": (5, 6)}
SCHEDULES = {
    "none": {"schedular": None},
    "StepLR": {"schedular": "StepLR", "schedular_step_size": 10, "schedular_gamma": 0.5},
    # 12 twice: optax's schedule takes the milestones as a dict (one decay).
    "MultiStepLR": {"schedular": "MultiStepLR", "schedular_milestones": [5, 12, 12, 20],
                    "schedular_gamma": 0.5},
    "ExponentialLR": {"schedular": "ExponentialLR", "schedular_gamma": 0.9},
}


def _cfg(load, path, optimizer, schedule, fused):
    cfg = load(path)
    cfg.OPTIMIZATION.optimizer = optimizer
    cfg.OPTIMIZATION.learning_rate = 1e-2
    cfg.OPTIMIZATION.fused_update = fused
    cfg.OPTIMIZATION.update(SCHEDULES[schedule])
    return cfg


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("optimizer", ["Adam", "SGD", "RMSprop", "Adagrad"])
def test_optimizer_matches_optax(optimizer, schedule, fused):
    rng = np.random.default_rng(0)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    for g in grads[::7]:
        g["bn"][:] = 0.0  # a masked (frozen) tensor now and then

    tx = jax_make_optimizer(_cfg(jax_load_yaml, jax_default_path(), optimizer, schedule, fused))
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)

    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt, sched = make_optimizer(_cfg(load_yaml, default_config_path(), optimizer, schedule,
                                     fused), tensors.values())
    lrs = []
    for g in grads:
        for k, p in tensors.items():
            p.grad = torch.from_numpy(g[k])
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    for k, p in tensors.items():
        got, want = p.detach().numpy(), np.asarray(params[k])
        assert np.abs(got - init[k]).max() > 1e-3  # the parameters moved
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max(),
                                   err_msg=k)
    if schedule == "MultiStepLR":  # decays at 5, 12 (once) and 20
        assert lrs[4] == 1e-2 and lrs[5] == 5e-3 and lrs[12] == 2.5e-3 and lrs[20] == 1.25e-3


def test_unknown_optimizer_and_schedule_raise():
    cfg = _cfg(load_yaml, default_config_path(), "LBFGS", "none", False)
    with pytest.raises(ValueError, match="optimizer"):
        make_optimizer(cfg, [torch.nn.Parameter(torch.zeros(2))])
    cfg = _cfg(load_yaml, default_config_path(), "Adam", "none", False)
    cfg.OPTIMIZATION.schedular = "CosineLR"
    with pytest.raises(ValueError, match="schedular"):
        make_optimizer(cfg, [torch.nn.Parameter(torch.zeros(2))])


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_numpy_transcription_matches_optax(kind):
    import jax

    from chip_smoke import OPTAX_STEPS, optax_inputs, optax_reference

    init, grads = optax_inputs()
    lrs = [1e-2 * 0.5 ** (t // 10) for t in range(OPTAX_STEPS)]
    want = optax_reference(kind, init, grads, lrs)
    with jax.enable_x64(True):
        schedule = optax.exponential_decay(1e-2, 10, 0.5, staircase=True)
        tx = (optax.adam(schedule) if kind == "adam" else
              optax.chain(optax.add_decayed_weights(1e-3), optax.sgd(schedule, momentum=0.9)))
        params = {k: jnp.asarray(v, jnp.float64) for k, v in init.items()}
        state = tx.init(params)
        for g in grads:
            updates, state = tx.update({k: jnp.asarray(v, jnp.float64) for k, v in g.items()},
                                       state, params)
            params = optax.apply_updates(params, updates)
        got = {k: np.asarray(v) for k, v in params.items()}
    for k in want:
        assert got[k].dtype == np.float64
        assert np.abs(got[k] - init[k]).max() > 1e-3
        np.testing.assert_allclose(want[k], got[k], rtol=1e-7, atol=1e-7 * np.abs(got[k]).max(),
                                   err_msg=k)
