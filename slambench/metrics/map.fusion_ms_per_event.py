"""Mean device ms of the ``fusion`` phase (the fusing forward and the
frame's fusion into the map, ``slam/fusion.py``) over the traced units'
replayed keyframe events, from the program's in-graph timestamps."""

from slambench.program_trace import replayed_phase_ms

LAYER = "map (ops.spatial_sort, slam.fusion)"
UNIT = "ms/event"


def read(summary):
    ms = replayed_phase_ms(summary, "fusion")
    return sum(ms) / len(ms) if ms else None
