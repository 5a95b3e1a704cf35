"""CPU tests of the readers of the program's own trace (run: ``python -m
pytest slambench -q``): the six readers on a synthetic trace, None where
the program keeps no trace, and the breakdown's labelling of an idle gap
by the program's span around it.
"""

from __future__ import annotations

import collections
import json
import os
import sys
from types import SimpleNamespace

import pytest

from slambench import run as harness
from slambench import trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NEW = ("program.event_ms_p95", "program.eager_s", "map.sort_ms_per_event",
       "map.fusion_ms_per_event", "step.loss_ms_per_step", "step.optimizer_ms_per_step")


def _readers():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    readers = harness.per_layer_metrics(bench, "default-seq60")
    assert set(NEW) <= set(readers)
    return readers


def _trace(rows, replayed, eager_s):
    """A one-step run's trace: phases inputs, sort, 5 step phases, fusion,
    rows."""
    return {"phases": ["inputs", "sort", "forward.0", "loss.0", "backward.0", "optimizer.0",
                       "metrics.0", "fusion", "rows"],
            "event_phase_ms": rows, "replayed": replayed,
            "span_s": {"program.eager_event": eager_s, "program.replay": 0.5}}


@pytest.fixture
def kept(monkeypatch):
    from e2eslam_tpu_torch.utils import tracing

    log = collections.deque(maxlen=64)
    monkeypatch.setattr(tracing, "TRACES", log)
    return log


def test_the_readers_on_a_synthetic_trace(kept):
    readers = _readers()
    kept.append(_trace([[9] * 9], [False], 99.0))  # an older run: not a traced unit's
    kept.append(_trace([[1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 1, 1, 1, 1, 1, 1, 1, 1],
                        [2, 4, 1, 6, 1, 2, 1, 3, 0]], [False, True, True], 0.25))
    kept.append(_trace([[1, 1, 1, 1, 1, 1, 1, 1, 1], [1, 2, 1, 2, 1, 4, 1, 1, 1]],
                       [False, True], 0.75))
    got = {m: readers[m].read({"units": 2}) for m in NEW}
    events = sorted([9.0, 20.0, 14.0])  # summed phases of the three replayed events
    assert got["program.event_ms_p95"] == pytest.approx(
        events[1] + 0.9 * (events[2] - events[1]))
    assert got["program.eager_s"] == pytest.approx(0.5)
    assert got["map.sort_ms_per_event"] == pytest.approx((1 + 4 + 2) / 3)
    assert got["map.fusion_ms_per_event"] == pytest.approx((1 + 3 + 1) / 3)
    assert got["step.loss_ms_per_step"] == pytest.approx((1 + 6 + 2) / 3)
    assert got["step.optimizer_ms_per_step"] == pytest.approx((1 + 2 + 4) / 3)


def test_the_readers_find_nothing_without_the_programs_trace(kept, monkeypatch):
    readers = _readers()
    for m in NEW:
        assert readers[m].read({"units": 1}) is None  # no traced run kept
    kept.append(_trace([[1] * 9], [False], 0.1))
    assert readers["program.eager_s"].read({"units": 1}) == pytest.approx(0.1)
    assert readers["map.sort_ms_per_event"].read({"units": 1}) is None  # no replay
    assert readers["program.eager_s"].read({"units": 2}) is None  # fewer traces than units
    monkeypatch.setitem(sys.modules, "e2eslam_tpu_torch.utils.tracing", None)
    for m in NEW:  # a program without the tracing module
        assert readers[m].read({"units": 1}) is None


def _event(name, start, end, parent=None, device="CPU", annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=f"DeviceType.{device}", cpu_parent=parent,
                           is_user_annotation=annotation)


def test_a_gap_is_labelled_by_the_program_span_around_it():
    """The program's ``e2eslam.`` ranges are host operators under the
    benchmark's ranges, so an idle gap inside one is labelled with it, the
    operators under it stay out of the host list, and its device-side
    annotation stays out of the busy time."""
    run = _event("slambench.run", 0.0, 100.0)
    eager = _event("e2eslam.program.eager_event", 10.0, 60.0, parent=run)
    events = [run, eager,
              _event("aten::conv2d", 12.0, 20.0, parent=_event("e2eslam.step.forward", 11.0,
                                                                  21.0, parent=eager)),
              _event("e2eslam.program.readback", 70.0, 90.0, parent=run),
              _event("e2eslam.program.eager_event", 10.0, 60.0, device="CUDA",
                     annotation=True),
              _event("conv_kernel", 15.0, 30.0, device="CUDA"),
              _event("copy", 55.0, 75.0, device="CUDA")]
    profile = trace.read_profile(events)
    assert [h[2] for h in profile["host"]] == ["e2eslam.program.eager_event",
                                               "e2eslam.program.readback"]
    bd = trace.breakdown(profile, (0.0, 100.0))
    assert bd["busy_s"] == pytest.approx(35e-6)
    assert dict(bd["idle_gaps"]) == pytest.approx({
        "run/e2eslam.program.eager_event": 25e-6,
        "run/e2eslam.program.readback": 25e-6,
        "run/python": 15e-6})
