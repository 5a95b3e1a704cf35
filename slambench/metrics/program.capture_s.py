"""Mean CUDA-graph capture time of the window's units, by the program's
own clock (``capture_s`` of each run's result)."""

LAYER = "program (engine.adaptation, parallel.adaptation)"
UNIT = "s"


def read(summary):
    values = summary.get("window_capture_s") or []
    return sum(values) / len(values) if values else None
