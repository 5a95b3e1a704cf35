"""The caching allocator's device allocations plus frees (its ``cudaMalloc``
and ``cudaFree`` calls) during each traced unit's program, the traced
units' mean: the ``counts`` of each unit's ``trace`` (the program's
``device_allocs`` and ``device_frees``). A program that keeps no such
count gives None."""

from slambench.program_trace import traces

LAYER = "program (engine.adaptation, parallel.adaptation)"
UNIT = "calls"


def read(summary):
    found = traces(summary)
    if not found or not all("device_allocs" in t.get("counts", {}) for t in found):
        return None
    return sum(t["counts"]["device_allocs"] + t["counts"]["device_frees"]
               for t in found) / len(found)
