"""Device time of the port's KNN kernels (names ``knn_*``) per refinement
step over the traced units."""

from slambench.trace import family

LAYER = "KNN (ops.knn, ops/csrc/knn.cu)"
UNIT = "ms/step"


def read(summary):
    ms = sum(t for n, t in summary.get("device_ops", {}).items() if family(n) == "knn") * 1e3
    return ms / summary["steps"] if ms > 0 and summary.get("steps") else None
