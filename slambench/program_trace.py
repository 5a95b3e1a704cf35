"""The program's own trace of the traced units, for the per-layer readers.

A run of the port that starts while a ``torch.profiler`` records keeps its
result's ``trace`` (``e2eslam_tpu_torch/utils/tracing.py``) in the
program's ``TRACES``: each keyframe event's phase times from timestamps the
device wrote inside the program's CUDA graph (``event_phase_ms`` [E][P],
``phases``, ``replayed``) and each host span's seconds (``span_s``). In a
result line's process the traced units are the only runs under a profiler,
so the newest ``summary["units"]`` traces are theirs. A program that keeps
no trace gives None.
"""

from __future__ import annotations

from typing import List, Optional


def traces(summary) -> Optional[List[dict]]:
    """The traced units' traces, oldest first; None where the program has
    none."""
    try:
        from e2eslam_tpu_torch.utils.tracing import TRACES
    except ImportError:
        return None
    n = int(summary.get("units") or 0)
    if n <= 0 or len(TRACES) < n:
        return None
    return list(TRACES)[-n:]


def replayed_phase_ms(summary, phase: str) -> Optional[List[float]]:
    """Per replayed event of the traced units, the ms of its phases named
    ``phase`` (a step's phase summed over the event's steps); None where
    the program has no replayed event."""
    out = []
    for trace in traces(summary) or ():
        cols = [j for j, name in enumerate(trace["phases"]) if name.split(".")[0] == phase]
        out += [sum(row[j] for j in cols)
                for row, r in zip(trace["event_phase_ms"], trace["replayed"]) if r and cols]
    return out or None


def steps_per_event(summary) -> Optional[int]:
    """The program's steps in an event (each a refinement step of every
    sequence the program holds)."""
    found = traces(summary)
    return sum(n.startswith("loss.") for n in found[-1]["phases"]) if found else None
