"""Model FLOPs of the traced units' events over the traced span and the
card's peak in the network's compute dtype, in percent (the configuration's
reference module's ``flops_per_event``, ``reference/__init__.py``: per
event R forward and backward passes and one forward for fusion, two frames
each)."""

LAYER = "step (engine.refine)"
UNIT = "%"


def read(summary):
    peak, span = summary.get("peak_flops"), summary.get("window_s")
    if not peak or not span or not summary.get("flops"):
        return None
    return 100.0 * summary["flops"] / span / peak
