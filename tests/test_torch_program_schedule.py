"""How the port's two programs run their keyframe events
(``engine/refine.py::event_schedule``), on the CPU.

On a card with E >= 3 events, event 0 runs eagerly, event 1 is captured as
the program's CUDA graph and replayed, and every later event is a replay;
with E <= 2, and on the CPU, every event runs eagerly. Each case runs the
single-sequence program (``RefinementEngine.process_sequence``) or the
fleet's (``ParallelAdaptation._run_program``) over E events on the CPU with
the event body replaced by a spy, so the loop's order, its first-event
fusion and its counts are held without the events' arithmetic (the run
tests hold that). The card's side of the rule is held here as the schedule
the programs read; ``tests/test_torch_cuda.py`` runs it on the card.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import pytest
import torch

from e2eslam_tpu_torch.apps.profile_adaptation import make_sequences
from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation
from e2eslam_tpu_torch.engine.refine import event_schedule
from e2eslam_tpu_torch.models.depth_net import make_depth_model
from e2eslam_tpu_torch.parallel.adaptation import ParallelAdaptation
from e2eslam_tpu_torch.utils import tracing

H = W = 64
L = 3


def _cfg():
    cfg = load_yaml(default_config_path())
    cfg.DATA.height, cfg.DATA.width = H, W
    cfg.DEMO.sequence_length = L
    cfg.DEMO.frame_threshold = 0.01
    cfg.OPTIMIZATION.refinement_steps = 1
    cfg.DEBUG.print_metrics = False
    cfg.SETTINGS.device = "cpu"
    return cfg


@pytest.fixture(scope="module")
def frames():
    return tuple(torch.as_tensor(x) for x in make_sequences(1, L, H, W))


def _single(E, frames, calls):
    cfg = _cfg()
    engine = OnlineAdaptation(cfg, device="cpu", model=make_depth_model(cfg, seed=0)).engine

    def spy(seq, K, pair_i, ev_i, ms, carry, out, est, *, fuse_prev):
        calls.append((int(ev_i), pair_i.tolist(), fuse_prev))

    engine._sequence_event = spy
    c, d, K, p = (x[0] for x in frames)
    prev = [e % 2 for e in range(E)]
    _, _, _, info = engine.process_sequence(engine.make_empty_map(), c, d, K, p, prev,
                                            [e + 1 for e in prev])
    return info


def _fleet(E, frames, calls):
    cfg = _cfg()
    par = ParallelAdaptation(cfg, make_depth_model(cfg, seed=0), map_capacity=L * H * W,
                             n_seq=1, device="cpu")

    def spy(state, seq, ins, maps, carry, out, est, *, fuse_prev):
        pi, act, ev_i = ins
        calls.append((int(ev_i), pi[0].tolist(), fuse_prev))

    par._event = spy
    schedule = [(e % 2, e % 2 + 1) for e in range(E)]
    return par._run_program(par.init_state(), frames, [schedule], E)[-1]


@pytest.mark.parametrize("program", ["single", "fleet"])
@pytest.mark.parametrize("E", [1, 2, 3, 12, 60])
def test_event_schedule(frames, program, E):
    """On a card: event 0 eager, event 1 captured and replayed, events
    2..E-1 replays, from E = 3; all eager below. On the CPU: every event
    eagerly, in order, event 0 alone fusing its previous frame; the
    program's ``counts`` and its traced run's say E eager events and no
    allocator call, and the trace marks no event replayed."""
    card = event_schedule(E, cuda=True)
    assert len(card) == E and card.count("capture") == (1 if E >= 3 else 0)
    assert [k == "eager" for k in card] == [e == 0 or E <= 2 for e in range(E)]
    assert [k == "replay" for k in card] == [e >= 2 and E >= 3 for e in range(E)]
    if E >= 3:
        assert card.index("capture") == 1
    assert event_schedule(E, cuda=False) == ["eager"] * E

    calls = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.session() as tr:
            info = (_single if program == "single" else _fleet)(E, frames, calls)
    trace = tr.finish()
    assert calls == [(e, [e % 2, e % 2 + 1], e == 0) for e in range(E)]
    assert info["graphs"] == 0 and info["capture_s"] == 0.0
    assert info["counts"] == {"device_allocs": 0, "device_frees": 0, "eager_events": E}
    assert trace["counts"] == info["counts"]
    assert trace["replayed"] == [False] * E


def test_the_allocator_calls_reader(monkeypatch):
    """``program.allocator_calls_per_unit`` is read in every cell: the
    traced units' mean of their programs' device allocations plus frees;
    None where a traced unit's trace has no counts (a program without
    them) or no trace was kept."""
    import collections
    import json
    import os

    from slambench import run as harness

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    name = "program.allocator_calls_per_unit"
    readers = [harness.per_layer_metrics(bench, w["name"]).get(name) for w in bench["workloads"]]
    assert all(r is not None for r in readers)
    read = readers[0].read
    log = collections.deque(maxlen=64)
    monkeypatch.setattr(tracing, "TRACES", log)
    assert read({"units": 1}) is None
    log.append({"counts": {"device_allocs": 90, "device_frees": 80, "eager_events": 2}})
    log.append({"counts": {"device_allocs": 3, "device_frees": 1, "eager_events": 1}})
    log.append({"counts": {"device_allocs": 0, "device_frees": 0, "eager_events": 1}})
    assert read({"units": 2}) == 2.0
    assert read({"units": 3}) == pytest.approx(58.0)
    log.append({"span_s": {}})  # a program that keeps no counts
    assert read({"units": 1}) is None and read({"units": 2}) is None
