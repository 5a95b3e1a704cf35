"""Snapshots of the program's state before chosen keyframe events of a run.

The output check follows a sequence's last keyframe event from the state
the program held just before it: the network's weights, Adam's moments, the
learning-rate count and the map. The program keeps that state in its own
tensors and overwrites it at the next event, inside a CUDA graph's replay,
so ``recording`` wraps the three places where an event starts and clones
the state there, on the device and in stream order, with no host read:

  * ``RefinementEngine._sequence_event`` and ``ParallelAdaptation._event``,
    the eager events (every event on the CPU; events 0 and 1 on a card),
    skipped while a graph captures them;
  * ``RefinementEngine._capture_event`` and ``ParallelAdaptation._capture_event``,
    which only note where the state lives;
  * ``torch.cuda.CUDAGraph.replay``, every later event on a card.

The events are counted from 0 in the order the program runs them. A
snapshot is plain tensors under the network's state-dict names, stacked on
a leading sequence axis (one row for a single sequence): ``weights``
(parameters and buffers), ``moments`` (``{name: (exp_avg, exp_avg_sq)}``
of every parameter Adam has stepped), ``adam_step`` and ``lr_count`` (0-d
tensors), ``maps`` (per sequence ``data``, ``count`` and the index images
and poses where the map keeps them).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List

import torch

MAP_FIELDS = ("data", "count", "index_image", "index_pose", "index_image2", "index_pose2")


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _clone(t):
    return t.detach().clone() if torch.is_tensor(t) else torch.tensor(t)


def map_fields(m) -> Dict[str, torch.Tensor]:
    return {f: _clone(getattr(m, f)) for f in MAP_FIELDS if getattr(m, f) is not None}


def _optimizer_fields(optimizer, names: Dict[int, str], schedule, scheduler) -> Dict:
    moments, step = {}, None
    for p, st in optimizer.state.items():
        if "exp_avg" in st:
            moments[names[id(p)]] = (st["exp_avg"].detach().clone(),
                                     st["exp_avg_sq"].detach().clone())
            step = st["step"]
    count = schedule.count if schedule is not None else scheduler.last_epoch
    return {"moments": moments, "adam_step": _clone(0.0 if step is None else step),
            "lr_count": _clone(count)}


def engine_state(engine, ms) -> Dict:
    """One sequence's state: ``engine`` (a ``RefinementEngine``), ``ms`` its map."""
    names = {id(p): n for n, p in engine.model.named_parameters()}
    out = {"weights": {k: v.detach()[None].clone() for k, v in engine.model.state_dict().items()},
           "maps": [map_fields(ms)]}
    out.update(_optimizer_fields(engine.optimizer, names, engine._schedule, engine.scheduler))
    out["moments"] = {k: (m[None], v[None]) for k, (m, v) in out["moments"].items()}
    return out


def batch_state(runner, state, maps) -> Dict:
    """Every sequence's state in the program over several
    (``ParallelAdaptation``; ``state`` its ``ParallelState``)."""
    names = {id(p): n for n, p in state.params.items()}
    out = {"weights": {k: v.detach().clone() for k, v in {**state.params, **state.buffers}.items()},
           "maps": [map_fields(m) for m in maps]}
    out.update(_optimizer_fields(state.optimizer, names, runner.par._schedule, state.scheduler))
    return out


class Recorder:
    """Counts a run's events and keeps a snapshot before each of
    ``events``: ``snaps[e]``."""

    def __init__(self, events: Iterable[int]):
        self.events = set(int(e) for e in events)
        self.snaps: Dict[int, Dict] = {}
        self.next = 0
        self.graph_state = None  # where a captured event's state lives

    def before_event(self, take) -> None:
        if self.next in self.events:
            self.snaps[self.next] = take()
        self.next += 1


def _wrap(obj, name, make, stack):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    stack.callback(setattr, obj, name, orig)


@contextlib.contextmanager
def recording(recorder: Recorder):
    """Snapshots into ``recorder`` for the runs inside the block."""
    from e2eslam_tpu_torch.engine.refine import RefinementEngine
    from e2eslam_tpu_torch.parallel.adaptation import ParallelAdaptation

    def eager_single(orig):
        def f(self, seq, K, pair_i, ev_i, ms, *a, **k):
            if not _capturing():
                recorder.before_event(lambda: engine_state(self, ms))
            return orig(self, seq, K, pair_i, ev_i, ms, *a, **k)
        return f

    def capture_single(orig):
        def f(self, seq, K, pair_i, ev_i, ms, *a, **k):
            recorder.graph_state = lambda: engine_state(self, ms)
            return orig(self, seq, K, pair_i, ev_i, ms, *a, **k)
        return f

    def eager_batch(orig):
        def f(self, state, seq, ins, maps, *a, **k):
            if not _capturing():
                recorder.before_event(lambda: batch_state(self, state, maps))
            return orig(self, state, seq, ins, maps, *a, **k)
        return f

    def capture_batch(orig):
        def f(self, state, seq, ins, maps, *a, **k):
            recorder.graph_state = lambda: batch_state(self, state, maps)
            return orig(self, state, seq, ins, maps, *a, **k)
        return f

    def replay(orig):
        def f(graph, *a, **k):
            if recorder.graph_state is not None:
                recorder.before_event(recorder.graph_state)
            return orig(graph, *a, **k)
        return f

    with contextlib.ExitStack() as stack:
        _wrap(RefinementEngine, "_sequence_event", eager_single, stack)
        _wrap(RefinementEngine, "_capture_event", capture_single, stack)
        _wrap(ParallelAdaptation, "_event", eager_batch, stack)
        _wrap(ParallelAdaptation, "_capture_event", capture_batch, stack)
        if hasattr(torch.cuda, "CUDAGraph"):
            _wrap(torch.cuda.CUDAGraph, "replay", replay, stack)
        yield recorder


def followed_events(counts: List[int]) -> List[int]:
    """The events the check follows in a unit whose sequences have
    ``counts`` keyframe events: each sequence's last."""
    return sorted({c - 1 for c in counts if c > 0})


def snapshot_events(counts: List[int]) -> List[int]:
    """The events to snapshot before: each followed event, and the one
    after it where the run goes on (its state is the followed event's
    result)."""
    E = max(counts)
    out = set(followed_events(counts))
    out |= {e + 1 for e in out if e + 1 < E}
    return sorted(out)
