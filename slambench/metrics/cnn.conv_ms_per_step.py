"""Device time of the convolution kernels (cuDNN and CUTLASS names,
``trace.py::FAMILIES``) per refinement step over the traced units."""

from slambench.trace import family

LAYER = "CNN (models)"
UNIT = "ms/step"


def read(summary):
    ms = sum(t for n, t in summary.get("device_ops", {}).items() if family(n) == "conv") * 1e3
    return ms / summary["steps"] if ms > 0 and summary.get("steps") else None
