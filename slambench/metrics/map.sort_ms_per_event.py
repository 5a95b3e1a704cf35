"""Mean device ms of the ``sort`` phase (the Morton sort of the map's
whole buffer, ``ops/spatial_sort.py``) over the traced units' replayed
keyframe events, from the program's in-graph timestamps."""

from slambench.program_trace import replayed_phase_ms

LAYER = "map (ops.spatial_sort, slam.fusion)"
UNIT = "ms/event"


def read(summary):
    ms = replayed_phase_ms(summary, "sort")
    return sum(ms) / len(ms) if ms else None
