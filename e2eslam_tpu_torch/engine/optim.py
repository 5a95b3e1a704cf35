"""Optimizer and learning-rate schedule factories.

``OPTIMIZATION.optimizer: Adam`` with ``schedular: StepLR`` (the default
path). optax's Adam (``mu_hat / (sqrt(nu_hat) + eps)``, .9/.999/1e-8) is
torch's Adam formula. optax's schedule counts updates, so the caller steps
the scheduler after every ``optimizer.step()`` and keeps one optimizer for
the whole run.

``OPTIMIZATION.fused_update`` (the JAX package's ``fuse_update``: one Adam
over the flattened parameter vector, ``e2eslam_tpu/engine/optim.py:41-75``)
changes how the update runs, not what it computes: the element-wise
formula is the per-tensor Adam's. Here it selects torch's multi-tensor
Adam instead of a flat parameter buffer: the fused CUDA kernel
(``fused=True``) on the card, the ``foreach`` implementation on the CPU.
"""

from __future__ import annotations

import torch


def make_optimizer(config, params):
    """Returns (optimizer, scheduler) for ``params``."""
    opt = config.OPTIMIZATION
    kind = opt.optimizer
    if kind not in ("Adam", "SparseAdam"):
        raise NotImplementedError(
            f"OPTIMIZATION.optimizer {kind!r}: only Adam is ported; the other "
            "optimizers come with a later slice of the port"
        )
    params = list(params)
    impl = {}
    if opt.get("fused_update", False):
        on_cuda = bool(params) and params[0].device.type == "cuda"
        impl = {"fused": True} if on_cuda else {"foreach": True}
    optimizer = torch.optim.Adam(params, lr=float(opt.learning_rate),
                                 betas=(0.9, 0.999), eps=1e-8, **impl)
    sched = opt.get("schedular", None)
    if sched in (None, "none"):
        scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda _: 1.0)
    elif sched == "StepLR":
        scheduler = torch.optim.lr_scheduler.StepLR(
            optimizer, step_size=int(opt.schedular_step_size),
            gamma=float(opt.get("schedular_gamma", 0.5)))
    else:
        raise NotImplementedError(
            f"OPTIMIZATION.schedular {sched!r}: only StepLR is ported"
        )
    return optimizer, scheduler
