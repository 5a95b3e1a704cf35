"""Optimizer and learning-rate schedule factories.

``OPTIMIZATION.optimizer`` and ``schedular`` as the JAX package builds them
from optax (``e2eslam_tpu/engine/optim.py``), the reference's choices
(``utils/training_utils.py:11-88``):

  * Adam (``SparseAdam`` too): optax's Adam (``mu_hat / (sqrt(nu_hat) +
    eps)``, .9/.999/1e-8) is torch's formula, so torch's Adam runs it;
  * SGD: ``add_decayed_weights(1e-3)`` then ``sgd(momentum=0.9)``, which is
    torch's SGD with ``weight_decay=1e-3, momentum=0.9, dampening=0`` (the
    first momentum buffer is the gradient itself, optax's zero trace plus
    it);
  * RMSprop: optax's (``nu = 0.9 nu + 0.1 g^2``, ``g / sqrt(nu + 1e-8)``,
    ``nu`` starts at 0); torch's RMSprop (alpha 0.99, eps outside the root)
    computes another function, so ``RMSprop`` below is the port's own;
  * Adagrad: optax's (``acc`` starts at 0.1, ``g * rsqrt(acc + 1e-7)`` where
    ``acc > 0``, else 0); torch's puts eps outside the root, so ``Adagrad``
    below is the port's own.

Schedules count updates: the caller steps the scheduler after every
``optimizer.step()`` and keeps one optimizer for the whole run. StepLR is
optax's staircase decay, ExponentialLR its continuous one
(``lr * gamma^count``), MultiStepLR its piecewise-constant schedule, which
takes the milestones as a dict: a repeated milestone decays once, where
torch's ``MultiStepLR`` would decay twice.

``OPTIMIZATION.fused_update`` (the JAX package's ``fuse_update``: the
optimizer over one flattened parameter vector) changes how the update runs,
not what it computes: the element-wise formula is the per-tensor one. Here
it selects the multi-tensor implementations: torch's fused CUDA kernels for
Adam and SGD on the card, ``foreach`` on the CPU, and ``foreach`` for the
port's own RMSprop and Adagrad on either.
"""

from __future__ import annotations

import torch

OPTIMIZERS = ("Adam", "SparseAdam", "SGD", "RMSprop", "Adagrad")
SCHEDULES = (None, "none", "StepLR", "MultiStepLR", "ExponentialLR")


class _ElementwiseOptimizer(torch.optim.Optimizer):
    """An optimizer whose update is one element-wise formula over each
    parameter and its state; ``foreach`` runs it over the whole list of
    tensors in a few multi-tensor ops, otherwise tensor by tensor. Both
    give the same bits."""

    state_keys = ()

    def __init__(self, params, lr: float, *, foreach: bool = False, **defaults):
        super().__init__(params, dict(lr=lr, foreach=foreach, **defaults))

    def _init_state(self, p):
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p].update(self._init_state(p))
            grads = [p.grad for p in params]
            states = [[self.state[p][k] for p in params] for k in self.state_keys]
            if group["foreach"]:
                self._update(params, grads, *states, group)
            else:
                for i, p in enumerate(params):
                    self._update([p], [grads[i]], *[[s[i]] for s in states], group)
        return loss


class RMSprop(_ElementwiseOptimizer):
    """optax.rmsprop: ``nu <- decay nu + (1 - decay) g^2``,
    ``p <- p - lr g / sqrt(nu + eps)``, ``nu`` starting at ``initial_scale``."""

    state_keys = ("nu",)

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0, *, foreach: bool = False):
        super().__init__(params, lr, foreach=foreach, decay=decay, eps=eps,
                         initial_scale=initial_scale)

    def _init_state(self, p):
        return {"nu": torch.full_like(p, self.defaults["initial_scale"],
                                      memory_format=torch.preserve_format)}

    @staticmethod
    def _update(params, grads, nus, group):
        decay, eps, lr = group["decay"], group["eps"], group["lr"]
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1.0 - decay)
        torch._foreach_mul_(nus, decay)
        torch._foreach_add_(nus, g2)
        scale = torch._foreach_add(nus, eps)
        torch._foreach_rsqrt_(scale)
        torch._foreach_mul_(scale, grads)
        torch._foreach_add_(params, scale, alpha=-lr)


class Adagrad(_ElementwiseOptimizer):
    """optax.adagrad: ``acc <- acc + g^2``,
    ``p <- p - lr where(acc > 0, g / sqrt(acc + eps), 0)``, ``acc`` starting
    at ``initial_accumulator_value``."""

    state_keys = ("sum",)

    def __init__(self, params, lr: float, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7, *, foreach: bool = False):
        super().__init__(params, lr, foreach=foreach, eps=eps,
                         initial_accumulator_value=initial_accumulator_value)

    def _init_state(self, p):
        return {"sum": torch.full_like(p, self.defaults["initial_accumulator_value"],
                                       memory_format=torch.preserve_format)}

    @staticmethod
    def _update(params, grads, sums, group):
        eps, lr = group["eps"], group["lr"]
        torch._foreach_addcmul_(sums, grads, grads)
        scale = torch._foreach_add(sums, eps)
        torch._foreach_rsqrt_(scale)
        scale = [torch.where(s > 0, r, torch.zeros_like(r)) for s, r in zip(sums, scale)]
        torch._foreach_mul_(scale, grads)
        torch._foreach_add_(params, scale, alpha=-lr)


def _lr_lambda(opt):
    """The schedule as a factor of the base learning rate, per update count."""
    kind = opt.get("schedular", None)
    gamma = float(opt.get("schedular_gamma", 0.5))
    if kind in (None, "none"):
        return lambda count: 1.0
    if kind == "StepLR":
        size = int(opt.schedular_step_size)
        return lambda count: gamma ** (count // size)
    if kind == "MultiStepLR":
        milestones = sorted({int(m) for m in opt.schedular_milestones})
        return lambda count: gamma ** sum(count >= m for m in milestones)
    if kind == "ExponentialLR":
        return lambda count: gamma ** count
    raise ValueError(f"OPTIMIZATION.schedular {kind!r}: one of {SCHEDULES}")


def make_optimizer(config, params):
    """Returns (optimizer, scheduler) for ``params``."""
    opt = config.OPTIMIZATION
    kind = opt.optimizer
    if kind not in OPTIMIZERS:
        raise ValueError(f"OPTIMIZATION.optimizer {kind!r}: one of {OPTIMIZERS}")
    params = list(params)
    lr = float(opt.learning_rate)
    multi = bool(opt.get("fused_update", False))
    on_cuda = bool(params) and params[0].device.type == "cuda"
    # torch's multi-tensor paths: the fused CUDA kernel on the card,
    # foreach on the CPU.
    impl = ({"fused": True} if on_cuda else {"foreach": True}) if multi else {}
    if kind in ("Adam", "SparseAdam"):
        optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, **impl)
    elif kind == "SGD":
        optimizer = torch.optim.SGD(params, lr=lr, momentum=0.9, dampening=0.0,
                                    weight_decay=1e-3, **impl)
    elif kind == "RMSprop":
        optimizer = RMSprop(params, lr=lr, foreach=multi)
    else:
        optimizer = Adagrad(params, lr=lr, foreach=multi)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, _lr_lambda(opt))
    return optimizer, scheduler
