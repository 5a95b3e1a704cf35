"""Host seconds per traced unit inside the program's eager keyframe events
(the ``e2eslam.program.eager_event`` spans: events 0 and 1, which set up
cuDNN, autograd and the optimizer before the capture)."""

from slambench.program_trace import traces

LAYER = "program (engine.adaptation, parallel.adaptation)"
UNIT = "s"


def read(summary):
    found = traces(summary)
    if not found or not any("program.eager_event" in t["span_s"] for t in found):
        return None
    return sum(t["span_s"].get("program.eager_event", 0.0) for t in found) / len(found)
