"""Share of the traced span in which no kernel or copy ran on the card: 1
minus the union of the device's intervals over the span, in percent."""

LAYER = "device"
UNIT = "%"


def read(summary):
    span = summary.get("window_s")
    return 100.0 * (1.0 - summary["busy_s"] / span) if span and summary.get("busy_s") else None
