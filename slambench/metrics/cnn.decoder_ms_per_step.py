"""Device ms of the network's decoder per step of the program, forward and
backward: the ``decoder`` phase (the U-Net and the disparity head, to the
depth) and the ``decoder_grad`` phase (the backward from the network
output's completed gradient to the deepest encoder feature's), over the
traced units' replayed keyframe events, from the program's in-graph
timestamps. Programs whose step does not split the network (the fleet's)
have neither phase: nothing to read."""

from slambench.program_trace import replayed_phase_ms, steps_per_event

LAYER = "CNN (models)"
UNIT = "ms/step"


def read(summary):
    fwd, bwd = replayed_phase_ms(summary, "decoder"), replayed_phase_ms(summary, "decoder_grad")
    if not fwd or not bwd:
        return None
    return (sum(fwd) + sum(bwd)) / (len(fwd) * steps_per_event(summary))
