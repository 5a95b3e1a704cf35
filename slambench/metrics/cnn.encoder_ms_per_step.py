"""Device ms of the network's encoder per step of the program, forward and
backward: the ``encoder`` phase (the ResNet to its deepest feature) and the
``encoder_grad`` phase (the backward from that feature's completed gradient
to its end), over the traced units' replayed keyframe events, from the
program's in-graph timestamps. Programs whose step does not split the
network (the fleet's) have neither phase: nothing to read."""

from slambench.program_trace import replayed_phase_ms, steps_per_event

LAYER = "CNN (models)"
UNIT = "ms/step"


def read(summary):
    fwd, bwd = replayed_phase_ms(summary, "encoder"), replayed_phase_ms(summary, "encoder_grad")
    if not fwd or not bwd:
        return None
    return (sum(fwd) + sum(bwd)) / (len(fwd) * steps_per_event(summary))
