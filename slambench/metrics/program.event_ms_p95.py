"""95th percentile, over the traced units' replayed keyframe events, of
each event's device time from its first to its last timestamp written
inside the program's CUDA graph (``slambench/program_trace.py``): the time
from a keyframe's frames to its refined depth fused into the map."""

import numpy as np

from slambench.program_trace import traces

LAYER = "program (engine.adaptation, parallel.adaptation)"
UNIT = "ms"


def read(summary):
    events = [sum(row) for t in traces(summary) or ()
              for row, r in zip(t["event_phase_ms"], t["replayed"]) if r]
    return float(np.percentile(events, 95)) if events else None
