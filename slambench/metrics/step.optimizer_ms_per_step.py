"""Device ms of the ``optimizer`` phase (the update, its schedule and, at
B sequences, the masked commit) per step of the program, over the traced
units' replayed keyframe events, from the program's in-graph timestamps (a
step of the program: one refinement step of every sequence it holds)."""

from slambench.program_trace import replayed_phase_ms, steps_per_event

LAYER = "step (engine.refine)"
UNIT = "ms/step"


def read(summary):
    ms = replayed_phase_ms(summary, "optimizer")
    return sum(ms) / (len(ms) * steps_per_event(summary)) if ms else None
