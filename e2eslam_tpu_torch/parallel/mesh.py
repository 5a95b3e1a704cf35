"""Several sequences adapting in lockstep: the mesh and one refinement step.

The port of ``e2eslam_tpu/parallel/mesh.py``. Online adaptation of one
sequence never talks to another, so sequences scale along a ``data`` axis:

  * on one device (a mesh of size 1, the card itself) ``n_seq`` sequences
    batch. Their depth networks run as ONE call: ``torch.func.vmap`` of
    ``torch.func.functional_call`` over parameters and buffers stacked on a
    leading ``[n_seq]`` axis, so each convolution sees every sequence's
    images at once (a grouped convolution). Everything after the network
    runs per sequence, in a loop: scaling, view synthesis, the loss family
    with its KNN calls, fusion. The per-sequence losses are summed before
    one backward, which gives each sequence exactly its own gradient, and
    one optimizer steps the stacked tensors (element-wise, so N separate
    optimizers in one).
  * a ``data`` axis of ``D > 1`` devices is one process per device
    (``torch.distributed``), each holding ``n_seq / D`` sequences, batched
    as above. No collective runs until ``ParallelAdaptation.run`` gathers
    the per-sequence results at the end.

Each sequence keeps its own engine (``engine/refine.py``): its random
generator (seeded from ``SETTINGS.seed`` plus the sequence's index, so a
sequence's draws do not depend on which others share the batch), its depth
regularizer's reference and its KNN warm starts. The engines share the
runner's network module, whose weights the stacked tensors replace in the
batched call; their own optimizers stay unused.

Batch norm stays in inference mode (the model's ``train`` keeps it so), so
the stacked running statistics are only read.

Which sequences a step commits is an ``active`` mask, known on the host
(the per-event loop: an inactive sequence takes no loss and fuses nothing)
or a ``[n_local]`` bool tensor on the device (the multi-sequence program,
``parallel/adaptation.py``: every sequence computes, its loss selected by
the mask and its fusion masked, with no host read). Either way the
optimizer's step is committed as the JAX runner's ``where(act, new, old)``
over every stepped tensor and its optimizer state. While the program runs
on a card (``_schedule`` set) the learning rate is ``DeviceSchedule``'s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call, vmap

from e2eslam_tpu_torch.device import resolve_device, set_full_fp32
from e2eslam_tpu_torch.engine.optim import DeviceSchedule, make_optimizer
from e2eslam_tpu_torch.engine.refine import PairBatch, RefinementEngine, validate_config
from e2eslam_tpu_torch.models.convert import load_depth_weights
from e2eslam_tpu_torch.models.depth_net import make_depth_model
from e2eslam_tpu_torch.slam.pointclouds import MapState
from e2eslam_tpu_torch.utils import tracing

Tensor = torch.Tensor


@dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: ``size`` processes of ``group`` (None: this
    process alone, or the default group), this one ``rank``, on
    ``device``."""

    size: int
    rank: int
    group: object
    device: torch.device
    axis: str = "data"


def make_mesh(n_devices: Optional[int] = None, axis: str = "data", *, group=None,
              device=None) -> Mesh:
    """A mesh of ``n_devices`` (default: every rank of ``group``, or of the
    default process group; one device without one). Each rank is one
    device: ``device`` (``"cpu"``, or CUDA unless asked for the CPU; with
    several ranks on CUDA, the card ``rank % device_count``). Asking for
    more devices than the group has raises."""
    distributed = dist.is_available() and dist.is_initialized()
    available = dist.get_world_size(group) if distributed else 1
    n = int(n_devices or available)
    if n > available:
        raise ValueError(f"requested a {n}-device mesh but only {available} device(s) are "
                         "available")
    dev = resolve_device(device)
    if n == 1:
        return Mesh(1, 0, None, dev, axis)
    if n != available:
        raise ValueError(f"a {n}-device mesh needs a process group of {n} ranks; the group "
                         f"has {available}")
    rank = dist.get_rank(group)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(n, rank, group, dev, axis)


@dataclass
class ParallelState:
    """The local sequences' networks and their optimizer: ``params`` and
    ``buffers`` keyed as the network's own, each ``[n_local, ...]``; one
    optimizer and schedule over the stacked parameters."""

    params: Dict[str, Tensor]
    buffers: Dict[str, Tensor]
    optimizer: torch.optim.Optimizer
    scheduler: object


def local_rows(mesh: Mesh, n_seq: int, tree, device) -> tuple:
    """This rank's rows of each ``[n_seq, ...]`` array or tensor of
    ``tree`` (a tuple), float32 on ``device``: the rows of the sequences it
    holds (the JAX ``shard_leading``: on the port's mesh each rank is a
    process that keeps its own slice of the leading axis)."""
    n = n_seq // mesh.size
    first = mesh.rank * n

    def rows(x):
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        return x[first:first + n].to(device=device, dtype=torch.float32).contiguous()

    return tuple(rows(x) for x in tree)


def pair_of(pairs: PairBatch, i: int) -> PairBatch:
    """Sequence ``i``'s window of a stacked ``PairBatch``."""
    return PairBatch(colors=pairs.colors[i], gt_depths=pairs.gt_depths[i],
                     intrinsics=pairs.intrinsics[i], poses=pairs.poses[i])


class ParallelRefinement:
    """``n_seq`` independent sequences adapting in lockstep over the mesh.

    ``n_seq`` defaults to one sequence per mesh device and may be any
    multiple of the mesh size: ``n_seq / size`` sequences batch on each
    device. ``model`` is the network to adapt (default: the config's,
    ``make_depth_model`` with the configured weights); ``init_state``
    copies it (or given per-sequence weights) for every sequence.
    """

    def __init__(self, config, model: Optional[nn.Module] = None, *, map_capacity: int,
                 mesh: Optional[Mesh] = None, n_seq: Optional[int] = None, device=None):
        validate_config(config)
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        size = self.mesh.size
        self.n = size if n_seq is None else int(n_seq)
        if self.n < 1 or self.n % size != 0:
            raise ValueError(f"n_seq={self.n} must be a positive multiple of mesh size {size}")
        self.n_local = self.n // size
        self.first = self.mesh.rank * self.n_local  # global index of the first local sequence
        self.device = self.mesh.device
        set_full_fp32()
        self.config = config
        if model is None:
            model = make_depth_model(config)
            load_depth_weights(config, model)
        self.model = model.to(self.device)
        self.map_capacity = int(map_capacity)
        self.engines = [RefinementEngine(config, self.model, map_capacity=self.map_capacity,
                                         device=self.device) for _ in range(self.n_local)]
        # The device learning-rate schedule while the program runs on a card.
        self._schedule: Optional[DeviceSchedule] = None
        self.reseed()

    def reseed(self, seeds: Optional[Sequence[int]] = None) -> None:
        """Seed each local sequence's generator: ``seeds[global index]``, by
        default ``SETTINGS.seed`` (1 when unset) plus the index; clear each
        engine's depth-regularizer reference."""
        base = self.config.SETTINGS.get("seed")
        base = 1 if base is None else int(base)
        for j, engine in enumerate(self.engines):
            g = self.first + j
            engine.generator.manual_seed(int(seeds[g]) if seeds is not None else base + g)
            engine.initial_depths = None

    def init_state(self, weights: Union[None, nn.Module, Mapping[str, Tensor]] = None
                   ) -> ParallelState:
        """Each local sequence's network and one optimizer over them.

        ``weights``: None (the runner's network, copied to every sequence),
        a module of the same architecture (likewise), or a mapping of
        stacked per-sequence tensors ``{state-dict key: [n_seq, ...]}`` (for
        example ``models/convert.py::from_jax_params_stacked``), of which
        this rank takes its own sequences' rows."""
        n, dev = self.n_local, self.device
        own_params = dict(self.model.named_parameters())
        own_buffers = dict(self.model.named_buffers())

        def copies(t):
            return t.detach().to(dev).unsqueeze(0).repeat((n,) + (1,) * t.dim()).contiguous()

        if weights is None or isinstance(weights, nn.Module):
            src = self.model if weights is None else weights
            params = {k: copies(v) for k, v in src.named_parameters()}
            buffers = {k: copies(v) for k, v in src.named_buffers()}
        else:
            missing = [k for k in list(own_params) + list(own_buffers)
                       if k not in weights and not k.endswith("num_batches_tracked")]
            if missing:
                raise KeyError(f"stacked weights miss {missing[:8]}")
            rows = slice(self.first, self.first + n)

            def own(k, t):
                if k.endswith("num_batches_tracked") and k not in weights:
                    return copies(t)
                return weights[k][rows].to(device=dev, dtype=t.dtype).clone().contiguous()

            params = {k: own(k, v) for k, v in own_params.items()}
            buffers = {k: own(k, v) for k, v in own_buffers.items()}
        for k, p in params.items():
            p.requires_grad_(own_params[k].requires_grad)
        # The engine's rule: SGD steps every parameter (a zero gradient
        # standing in for a missing one), the other optimizers the trainable.
        sgd = self.config.OPTIMIZATION.optimizer == "SGD"
        stepped = [p for p in params.values() if sgd or p.requires_grad]
        optimizer, scheduler = make_optimizer(self.config, stepped)
        return ParallelState(params, buffers, optimizer, scheduler)

    def init_maps(self) -> List[MapState]:
        """An empty map per local sequence."""
        return [engine.make_empty_map() for engine in self.engines]

    def forward(self, state: ParallelState, x: Tensor) -> Tensor:
        """The network of every local sequence on its own images, one call:
        ``x [n_local, B, H, W, 3]`` -> the disparity ``[n_local, B, H, W, 1]``.
        One local sequence needs no batching: its network is called
        directly (under ``vmap`` of one, cuDNN's float32 batch norm asks
        the batched input for a channels-last layout, which ``vmap`` does
        not answer)."""
        def one(params, buffers, xi):
            return functional_call(self.model, (params, buffers), (xi,))

        if x.shape[0] == 1:
            first = {k: v[0] for k, v in state.params.items()}
            return one(first, {k: v[0] for k, v in state.buffers.items()}, x[0])[None]
        return vmap(one)(state.params, state.buffers, x)

    def _net_inputs(self, pairs: PairBatch) -> Tensor:
        return torch.stack([e.net_input(pairs.colors[i]) for i, e in enumerate(self.engines)])

    def refine_step(self, state: ParallelState, pairs: PairBatch, maps: List[MapState], *,
                    map_indices=None, knn_init=None, thread_knn: bool = False, step: int = 0,
                    active=None):
        """One PFT step of every active local sequence. ``pairs``: each
        field with a leading ``[n_local]`` axis; ``maps``, ``map_indices``
        and ``knn_init``: one entry per local sequence. ``active``: None
        (all), host flags (an inactive sequence runs the network with the
        others but takes no loss) or a device bool tensor (every sequence
        takes its loss, selected by the mask with ``where``, so that a
        padded window's NaN cannot reach the sum). An inactive sequence's
        parameters and optimizer state are kept as they were. Returns
        (metrics, KNN caches), one entry per local sequence (None where a
        host flag is off). Each sequence's metrics hold what the solo
        step's hold (``RefinementEngine.refine_step``), as the JAX runners'
        vmapped step gives each its own: with ``VIZ.log_gradients`` or
        ``VIZ.tensorboard`` its ``grad_norms``, the norm of its row of each
        stacked gradient (0 for the frozen parameters and the unused
        heads), with ``DEBUG.plot`` its ``debug_images``."""
        cfg = self.config
        obs_grads = bool(cfg.VIZ.get("log_gradients") or cfg.VIZ.get("tensorboard"))
        obs_images = bool(cfg.DEBUG.get("plot"))
        n = self.n_local
        flags, mask = _flags(active, n, self.device)
        map_indices = map_indices or [None] * n
        knn_init = knn_init or [None] * n
        with tracing.phase("step.forward"):
            # The program's replays keep the gradients' buffers: zeroed, not freed.
            state.optimizer.zero_grad(set_to_none=self._schedule is None)
            out = self.forward(state, self._net_inputs(pairs))
        F = pairs.colors.shape[1]
        on_device = torch.is_tensor(active)
        total, held = None, [None] * n
        with tracing.phase("step.loss"):
            for i, engine in enumerate(self.engines):
                if not flags[i]:
                    continue
                pair = pair_of(pairs, i)
                disp, depth = engine.depths_from_net(out[i], F)
                loss, aux, depth, outputs = engine.step_loss(pair, disp, depth, maps[i],
                                                             map_indices[i], knn_init[i],
                                                             thread_knn, step)
                term = torch.where(active[i], loss, torch.zeros_like(loss)) if on_device else loss
                total = term if total is None else total + term
                held[i] = (pair, depth, loss, aux, outputs)
        with tracing.phase("step.backward"):
            if total is not None:
                total.backward()
            norms = _row_norms(state.params) if obs_grads else None
        with tracing.phase("step.optimizer"):
            self._commit(state, mask)
        metrics, caches = [None] * n, [None] * n
        with tracing.phase("step.metrics"):
            for i, h in enumerate(held):
                if h is not None:
                    pair, depth, loss, aux, outputs = h
                    engine = self.engines[i]
                    caches[i] = aux.pop("_knn_idx", None)
                    metrics[i] = engine.step_metrics(pair, depth, loss, aux)
                    if obs_images:
                        metrics[i]["debug_images"] = engine._debug_images(pair, depth, outputs)
                    if norms is not None:
                        metrics[i]["grad_norms"] = dict(zip(state.params, norms[i]))
        return metrics, caches

    def _commit(self, state: ParallelState, mask: Optional[Tensor]) -> None:
        """The optimizer and schedule step, committed as ``where(mask, new,
        old)`` over each stepped tensor and its same-shaped optimizer state
        (Adam moves a parameter whose gradient is zero), the JAX runner's
        select (parallel/adaptation.py:150-154); ``mask`` None commits every
        row. State the optimizer has not made yet (its first step) is left
        as the step makes it.

        The step counter and the learning-rate schedule are shared: they
        are right for every sequence because each starts at event 0 and,
        once done, never steps again."""
        opt = state.optimizer
        stepped = [p for group in opt.param_groups for p in group["params"]]
        if self.config.OPTIMIZATION.optimizer == "SGD":
            for p in stepped:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        saved = save_rows(opt) if mask is not None else []
        if self._schedule is None:
            opt.step()
            state.scheduler.step()
        else:
            self._schedule.set_lr()
            opt.step()
            self._schedule.stepped()
        commit_rows(saved, mask)

    def fuse_pair(self, state: ParallelState, pairs: PairBatch, maps: List[MapState], *,
                  fuse_prev: bool, active=None):
        """Fuse each active local sequence's pair into its map, the network
        of every sequence in one call. ``active`` as ``refine_step``'s: a
        host flag off skips the sequence (its map as it was, its pose None);
        a device mask fuses every sequence, masked (``slam/fusion.py``: an
        inactive map comes out unchanged). Returns (maps, estimated poses)."""
        n = self.n_local
        flags, _ = _flags(active, n, self.device)
        with torch.no_grad():
            out = self.forward(state, self._net_inputs(pairs))
        F = pairs.colors.shape[1]
        maps, est = list(maps), [None] * n
        for i, engine in enumerate(self.engines):
            if flags[i]:
                _, depth = engine.depths_from_net(out[i], F)
                maps[i], est[i] = engine.fuse_depth(
                    pair_of(pairs, i), depth, maps[i], fuse_prev=fuse_prev,
                    active=active[i] if torch.is_tensor(active) else None)
        return maps, est


def save_rows(opt) -> list:
    """(tensor, copy) of each parameter ``opt`` steps and of its
    same-shaped optimizer state, before a masked step."""
    saved = []
    for p in (p for group in opt.param_groups for p in group["params"]):
        kept = [p] + [t for t in opt.state.get(p, {}).values()
                      if torch.is_tensor(t) and t.shape == p.shape]
        saved += [(t, t.detach().clone()) for t in kept]
    return saved


@torch.no_grad()
def commit_rows(saved: list, mask: Optional[Tensor]) -> None:
    """``t = where(mask, t, copy)`` along each saved tensor's leading
    ``[n_local]`` axis, in place."""
    for t, old in saved:
        torch.where(mask.reshape((-1,) + (1,) * (t.dim() - 1)), t, old, out=t)


def _row_norms(params: Dict[str, Tensor]) -> List[List[Tensor]]:
    """Each local sequence's gradient norm of each stacked parameter
    ``[n_local, ...]`` (its row of ``.grad``; 0 where there is none), one
    ``torch._foreach_norm`` over the rows, as the solo step takes its norms.
    Returns ``[n_local][parameter]`` 0-d tensors, in ``params``' order."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params.values()]
    n = grads[0].shape[0]
    norms = torch._foreach_norm([g[i].float() for i in range(n) for g in grads])
    return [norms[i * len(grads):(i + 1) * len(grads)] for i in range(n)]


def _flags(active, n: int, device):
    """(host flags, the commit mask) of ``active``: None (all on, no mask),
    host flags (the mask only where one is off) or a device bool tensor
    (all computed, the tensor the mask)."""
    if torch.is_tensor(active):
        return [True] * n, active
    flags = [True] * n if active is None else [bool(a) for a in active]
    return flags, None if all(flags) else torch.tensor(flags, device=device)
