"""Optimizer and learning-rate schedule factories.

``OPTIMIZATION.optimizer`` and ``schedular`` as the JAX package builds them
from optax (``e2eslam_tpu/engine/optim.py``), the reference's choices
(``utils/training_utils.py:11-88``):

  * Adam (``SparseAdam`` too): optax's Adam (``mu_hat / (sqrt(nu_hat) +
    eps)``, .9/.999/1e-8) is torch's formula, so torch's Adam runs it;
  * SGD: ``add_decayed_weights(1e-3)`` then ``sgd(momentum=0.9)``:
    ``SGD`` below, the port's own (torch's SGD reads a tensor learning rate
    to the host), every parameter decayed;
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
torch's ``MultiStepLR`` would decay twice. ``make_lr_schedule`` is the
schedule itself, a function of the update count.

The whole-sequence programs replay their events as CUDA graphs, where a
host schedule would be frozen at capture. ``DeviceSchedule`` runs the same
schedule on the device: each param group's ``lr`` is a 0-d tensor that
``set_lr`` recomputes from a device update count before each update
(``lr_factor``: ``_lr_lambda`` in tensor ops, as optax's schedule reads
its count), with torch's Adam in its ``capturable`` form (its step count on
the device; it rounds the update otherwise than the default form, within
1e-6 of optax's formula both). The port's own optimizers multiply the
update by the learning rate, a float or that tensor, in one way
(``_apply``), so the per-keyframe loop and the program compute the same
bits.

``OPTIMIZATION.fused_update`` (the JAX package's ``fuse_update``: the
optimizer over one flattened parameter vector) changes how the update runs,
not what it computes: the element-wise formula is the per-tensor one. Here
it selects the multi-tensor implementations: torch's fused CUDA kernel for
Adam on the card, ``foreach`` on the CPU, and ``foreach`` for the port's
own optimizers on either.
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
        _apply(params, scale, lr)


def _apply(params, scale, lr) -> None:
    """``p <- p - lr * scale``, optax's ``scale(-lr)`` then
    ``apply_updates``: the product rounded, then subtracted. A float ``lr``
    and a float32 tensor one (``DeviceSchedule``'s, multiplied in on the
    device, never read by the host) of the same value give the same bits."""
    torch._foreach_mul_(scale, lr)
    torch._foreach_sub_(params, scale)


class SGD(_ElementwiseOptimizer):
    """``optax.chain(add_decayed_weights(wd), sgd(lr, momentum))``:
    ``d <- g + wd p``, ``m <- d + momentum m`` (``m`` starting at 0),
    ``p <- p - lr m``. Dampening 0, no Nesterov."""

    state_keys = ("momentum_buffer",)

    def __init__(self, params, lr: float, momentum: float = 0.9, weight_decay: float = 1e-3,
                 *, foreach: bool = False):
        super().__init__(params, lr, foreach=foreach, momentum=momentum,
                         weight_decay=weight_decay)

    def _init_state(self, p):
        return {"momentum_buffer": torch.zeros_like(p, memory_format=torch.preserve_format)}

    @staticmethod
    def _update(params, grads, bufs, group):
        d = torch._foreach_mul(params, group["weight_decay"])
        torch._foreach_add_(d, grads)
        torch._foreach_mul_(bufs, group["momentum"])
        torch._foreach_add_(bufs, d)
        _apply(params, torch._foreach_mul(bufs, 1.0), group["lr"])


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
        _apply(params, scale, lr)


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


def lr_factor(opt, count: torch.Tensor) -> torch.Tensor:
    """``_lr_lambda(opt)`` on a device update count: a float64 0-d tensor
    from device ops alone (capturable in a CUDA graph); equal to the host
    factor for every count."""
    kind = opt.get("schedular", None)
    gamma = float(opt.get("schedular_gamma", 0.5))
    c = count.to(torch.float64)
    if kind in (None, "none"):
        return torch.ones_like(c)
    if kind == "StepLR":
        return gamma ** torch.floor(c / int(opt.schedular_step_size))
    if kind == "MultiStepLR":
        passed = sum((c >= m).to(torch.float64) for m in sorted({int(m) for m in
                                                                opt.schedular_milestones}))
        return gamma ** (passed + torch.zeros_like(c))
    if kind == "ExponentialLR":
        return gamma ** c
    raise ValueError(f"OPTIMIZATION.schedular {kind!r}: one of {SCHEDULES}")


class DeviceSchedule:
    """The schedule of ``make_optimizer``'s ``LambdaLR`` on the device, for
    updates that a CUDA graph replays. While entered, each param group's
    ``lr`` is a float32 0-d tensor on the device and torch's Adam runs
    ``capturable`` (its step counts on the device); ``set_lr`` writes
    ``base_lr * lr_factor(count)`` into it, ``count`` the device update
    count (the host scheduler's ``last_epoch`` on entry), and ``stepped``
    adds one. ``exit`` reads the count once and hands the schedule back to
    the host scheduler and the groups their float learning rates."""

    def __init__(self, config, optimizer, scheduler, device):
        self.opt = config.OPTIMIZATION
        self.optimizer, self.scheduler = optimizer, scheduler
        self.base = list(scheduler.base_lrs)
        self.count = torch.full((), int(scheduler.last_epoch), dtype=torch.int64, device=device)
        self.lrs = [torch.full((), float(g["lr"]), dtype=torch.float32, device=device)
                    for g in optimizer.param_groups]
        for g, lr in zip(optimizer.param_groups, self.lrs):
            g["lr"] = lr
            if "capturable" in g:
                g["capturable"] = device.type == "cuda"
        # Adam keeps a host step count unless capturable or fused.
        for st in optimizer.state.values():
            step = st.get("step")
            if isinstance(step, torch.Tensor) and step.device != device:
                st["step"] = step.to(device=device, dtype=torch.float32)

    def set_lr(self) -> None:
        factor = lr_factor(self.opt, self.count)
        for lr, base in zip(self.lrs, self.base):
            lr.copy_(factor * base)

    def stepped(self) -> None:
        self.count.add_(1)

    def exit(self) -> None:
        n = int(self.count)
        lam = _lr_lambda(self.opt)
        self.scheduler.last_epoch = n
        self.scheduler._last_lr = [base * lam(n) for base in self.base]
        for g, lr in zip(self.optimizer.param_groups, self.scheduler._last_lr):
            g["lr"] = lr
            if "capturable" in g:
                g["capturable"] = False


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
        optimizer = SGD(params, lr=lr, foreach=multi)
    elif kind == "RMSprop":
        optimizer = RMSprop(params, lr=lr, foreach=multi)
    else:
        optimizer = Adagrad(params, lr=lr, foreach=multi)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, _lr_lambda(opt))
    return optimizer, scheduler


def make_lr_schedule(config):
    """The learning rate as a function of the update count (optax's
    ``Schedule``, ``e2eslam_tpu/engine/optim.py:17-38``): a float for an int
    count, a float64 0-d tensor (device ops alone) for a tensor one."""
    opt = config.OPTIMIZATION
    lr = float(opt.learning_rate)
    lam = _lr_lambda(opt)

    def schedule(count):
        if isinstance(count, torch.Tensor):
            return lr_factor(opt, count) * lr
        return lr * lam(int(count))

    return schedule
