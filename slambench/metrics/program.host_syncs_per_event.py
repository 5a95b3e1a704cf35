"""Host synchronisations per keyframe event over the traced units: the
warnings of ``torch.cuda.set_sync_debug_mode("warn")``."""

LAYER = "program (engine.adaptation, parallel.adaptation)"
UNIT = "syncs/event"


def read(summary):
    events = summary.get("events")
    return summary["host_syncs"] / events if events else None
