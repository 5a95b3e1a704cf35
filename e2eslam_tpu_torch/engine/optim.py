"""Optimizer and learning-rate schedule factories.

``OPTIMIZATION.optimizer: Adam`` with ``schedular: StepLR`` (the default
path). optax's Adam (``mu_hat / (sqrt(nu_hat) + eps)``, .9/.999/1e-8) is
torch's Adam formula. optax's schedule counts updates, so the caller steps
the scheduler after every ``optimizer.step()`` and keeps one optimizer for
the whole run.
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
    optimizer = torch.optim.Adam(params, lr=float(opt.learning_rate),
                                 betas=(0.9, 0.999), eps=1e-8)
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
