"""The program's tracing (``utils/tracing.py``) on the CPU.

Tracing is on only for a run that starts while a ``torch.profiler``
records. Off, a run records no ``e2eslam.`` range, stamps nothing and its
result's ``trace`` is None. On, the run computes exactly what it computes
off (metrics, poses and map equal to the bit: the CPU runs every event
eagerly, and a mark is the host's clock) and its ``trace`` holds every
event's phase times: P = 4 + 8R in the whole-sequence program, whose
step splits the network at its encoder (``tracing.NETWORK_STEP_PHASES``),
and P = 4 + 5R in the program over B = 2 sequences. 64x64, 3 frames, R = 2.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)
from torch_omp import pinned_threads

import numpy as np
import pytest
import torch

from e2eslam_tpu_torch.apps.profile_adaptation import make_sequences
from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation
from e2eslam_tpu_torch.models.depth_net import make_depth_model
from e2eslam_tpu_torch.parallel.adaptation import ParallelAdaptation
from e2eslam_tpu_torch.utils import tracing

H = W = 64
L = 3
R = 2


def _cfg():
    cfg = load_yaml(default_config_path())
    cfg.DATA.height, cfg.DATA.width = H, W
    cfg.DEMO.sequence_length = L
    cfg.DEMO.frame_threshold = 0.01
    cfg.OPTIMIZATION.refinement_steps = R
    cfg.DEBUG.print_metrics = False
    cfg.SETTINGS.device = "cpu"
    return cfg


def _single():
    cfg = _cfg()
    runner = OnlineAdaptation(cfg, device="cpu", model=make_depth_model(cfg, seed=0))
    with pinned_threads(4):
        out = runner.run(verbose=False)
    assert out["sequence_program"] and len(out["keyframes"]) == L - 1
    return out


def _batch():
    cfg = _cfg()
    par = ParallelAdaptation(cfg, make_depth_model(cfg, seed=0), map_capacity=L * H * W,
                             n_seq=2, device="cpu")
    with pinned_threads(4):
        out = par.run(par.init_state(), make_sequences(2, L, H, W), threshold=0.01,
                      dispatch="whole")
    assert out["dispatch"] == "whole"
    return out


def _refuse(*a, **k):
    raise AssertionError("traced while no profiler records")


@pytest.fixture(scope="module")
def runs():
    """Each program run once without a profiler (a range or a mark raises)
    and once under one, with the ranges the profiler saw."""
    out = {}
    for name, run in (("single", _single), ("batch2", _batch)):
        before = len(tracing.TRACES)
        with pytest.MonkeyPatch.context() as m:
            m.setattr(tracing, "record_function", _refuse)
            m.setattr(tracing, "stamp", _refuse)
            plain = run()
        kept = len(tracing.TRACES) - before
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            traced = run()
        out[name] = (plain, kept, traced, {e.name for e in prof.events()})
    return out


def _same(a, b):
    """Two runs' metrics, poses and map equal to the bit."""
    for x, y in ((a, b),) if "per_sequence" not in a else zip(a["per_sequence"],
                                                              b["per_sequence"]):
        assert x["keyframes"] == y["keyframes"]
        assert x["metrics"] == y["metrics"]
        np.testing.assert_array_equal(x["est_poses"], y["est_poses"])
    for ma, mb in zip(a.get("maps", [a.get("map")]), b.get("maps", [b.get("map")])):
        assert ma.count == mb.count and torch.equal(ma.data, mb.data)


def test_off_without_a_profiler(runs):
    """No profiler: no range, no mark, no trace."""
    for plain, kept, _, _ in runs.values():
        assert plain["trace"] is None and kept == 0


STEPS = {"single": (tracing.NETWORK_STEP_PHASES, 8, {"e2eslam.step.encoder",
                                                     "e2eslam.step.decoder"}),
         "batch2": (tracing.STEP_PHASES, 5, set())}


@pytest.mark.parametrize("name", ["single", "batch2"])
def test_traced_run_computes_what_the_plain_run_does(runs, name):
    plain, _, traced, names = runs[name]
    step_phases, per_step, spans = STEPS[name]
    _same(plain, traced)
    assert {"e2eslam.program.eager_event", "e2eslam.step.loss", "e2eslam.event.fusion",
            "e2eslam.unit.build"} | spans <= names
    E = traced.get("num_events", len(traced.get("keyframes", ())))
    trace = traced["trace"]
    P = 4 + per_step * R
    assert trace["phases"] == tracing.phase_names(R, step_phases) and len(trace["phases"]) == P
    phase_ms = np.asarray(trace["event_phase_ms"])
    assert phase_ms.shape == (E, P) and np.isfinite(phase_ms).all()
    assert (phase_ms >= 0).all() and (phase_ms.sum(axis=1) > 0).all()
    assert trace["replayed"] == [False] * E  # the CPU runs every event eagerly
    assert {"unit.load_batch", "program.eager_event", "program.readback", "unit.summary",
            "event.sort", "step.loss", "step.optimizer", "event.fusion"} <= set(trace["span_s"])
    assert any(t is trace for t in tracing.TRACES)


def test_marks_ride_in_the_final_read():
    """``Session.read`` returns the table as ``.cpu().numpy()`` and keeps
    the marks relative to the run's first; ``finish`` differences them."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.session() as tr:
            tr.begin_events(2, tracing.phase_names(1), torch.device("cpu"),
                            replayed=[False, True])
            tr.stamps.copy_(torch.tensor([[10, 12, 15, 15, 20, 26, 27, 29, 30, 31],
                                          [40, 41, 43, 46, 50, 55, 61, 68, 76, 85]]) * 10**6)
            table = torch.arange(6, dtype=torch.float64).reshape(2, 3)
            np.testing.assert_array_equal(tracing.read(table), table.numpy())
    assert tr.marks[0, 0] == 0 and tr.marks[1, -1] == 75e6
    trace = tr.finish()
    assert trace["phases"] == tracing.phase_names(1) and trace["replayed"] == [False, True]
    np.testing.assert_array_equal(trace["event_phase_ms"],
                                  [[2, 3, 0, 5, 6, 1, 2, 1, 1], [1, 2, 3, 4, 5, 6, 7, 8, 9]])


def test_a_phase_out_of_order_raises():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.session() as tr:
            tr.begin_events(1, tracing.phase_names(1), torch.device("cpu"), replayed=[False])
            row = torch.zeros(1, dtype=torch.int64)
            with pytest.raises(RuntimeError, match="phase"):
                with tracing.event(row), tracing.phase("event.sort"):
                    pass
            with pytest.raises(RuntimeError, match="ran 1 of its"):
                with tracing.event(row), tracing.phase("event.inputs"):
                    pass


def test_union_counts_overlaps_once():
    busy = [(0.0, 4.0), (1.0, 2.0), (3.0, 6.0), (8.0, 9.0), (8.5, 8.7)]
    assert tracing.merge(busy) == [(0.0, 6.0), (8.0, 9.0)]
    assert tracing.union_length(busy) == pytest.approx(7.0)
