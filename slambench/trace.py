"""Reading a ``torch.profiler`` run: device intervals, their union, the
idle gaps and what the host was doing in them.

``FAMILIES`` is the sound part of the port's kernel-name classifier
(``e2eslam_tpu_torch/apps/profile_adaptation.py::FAMILIES``), frozen here:
the KNN kernels and the convolutions; its other families (sort, scatter,
elementwise) name kernels that several layers share. The idle share is
corrected from that file's ``1 - sum(kernel time) / wall``, which counts
overlapping kernels and copies twice, to 1 minus the union of the device's
intervals over the span.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Sequence, Tuple

FAMILIES = (  # (family, substrings of CUDA kernel names), first match wins
    ("knn", ("knn_",)),
    ("conv", ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad", "fprop", "winograd",
              "cutlass")),
)

RANGE_PREFIX = "slambench."


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    """Total length covered by ``(start, end)`` intervals, overlaps once."""
    return sum(e - s for s, e in merge(intervals))


def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: Sequence[Tuple[float, float]], span: Tuple[float, float]):
    """The idle intervals of ``span`` between merged ``busy`` intervals."""
    out, t = [], span[0]
    for s, e in merge(busy):
        s, e = max(s, span[0]), min(e, span[1])
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < span[1]:
        out.append((t, span[1]))
    return out


def read_profile(events) -> Dict:
    """From a profiler's ``events()``: the device's kernel and copy
    intervals (``(start_us, end_us, name)``), the benchmark's own ranges
    (``slambench.*``) and the host's top-level operators (each with its
    innermost benchmark range)."""
    device, ranges, host = [], [], []
    for ev in events:
        name = ev.name
        start, end = ev.time_range.start, ev.time_range.end
        if str(ev.device_type).endswith("CUDA"):
            if getattr(ev, "is_user_annotation", False) or name.startswith(RANGE_PREFIX):
                continue
            device.append((start, end, name))
        elif name.startswith(RANGE_PREFIX):
            ranges.append((start, end, name))
        else:
            parent = ev.cpu_parent
            if parent is None or parent.name.startswith(RANGE_PREFIX):
                host.append((start, end, name))
    return {"device": device, "ranges": ranges, "host": sorted(host)}


def _innermost(ranges, t: float) -> str:
    best = None
    for s, e, name in ranges:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2][len(RANGE_PREFIX):] if best else "outside"


def breakdown(profile: Dict, span: Tuple[float, float], top: int = 10) -> Dict:
    """The device's busy time over ``span`` (the union of its intervals),
    its operations with most time, and the idle gaps summed by what the
    host was doing at each gap's middle: the benchmark's innermost range
    and the host operator running then (``python`` where none)."""
    dev = [(max(s, span[0]), min(e, span[1]), n) for s, e, n in profile["device"]
           if e > span[0] and s < span[1]]
    busy_us = union_length([(s, e) for s, e, _ in dev])
    per_op: Dict[str, float] = {}
    for s, e, n in dev:
        per_op[n] = per_op.get(n, 0.0) + (e - s) * 1e-6
    host = profile["host"]
    starts = [h[0] for h in host]
    idle: Dict[str, float] = {}
    for s, e in gaps([(s, e) for s, e, _ in dev], span):
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid) - 1
        op = host[i][2] if i >= 0 and host[i][1] >= mid else "python"
        label = f"{_innermost(profile['ranges'], mid)}/{op}"
        idle[label] = idle.get(label, 0.0) + (e - s) * 1e-6
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (span[1] - span[0]) * 1e-6,
        "device_ops": per_op,
        "top_ops": sorted(([n[:120], t] for n, t in per_op.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([n[:120], t] for n, t in idle.items()), key=lambda x: -x[1])[:top],
    }
