"""The program's tracing: host spans and in-graph device timestamps for
each phase of its keyframe events.

One switch and no knob: tracing is on for a block when a ``torch.profiler``
records as the block starts (``session``; the runners open one for their
build and one for each run). Off, ``span``, ``phase`` and ``event`` return
one shared null context, nothing is timed or stamped, and a captured CUDA
graph holds exactly the kernels it holds without this module.

On:

  * ``span(name)`` is a ``torch.profiler.record_function`` range named
    ``e2eslam.<name>``, on the profiler's clock beside the device's
    kernels; the session sums each name's host seconds (``span_s``).
  * A program calls ``begin_events`` before its first keyframe event and
    wraps each event's body in ``event(ev_i)`` (``ev_i``: the program's own
    int64 event index, on its device). Each ``phase(name)`` then writes
    mark k of the event's row of a stamps buffer ``[E, P + 1]`` (int64
    ns) as phase k starts, and the event's end writes mark P. The phases
    (``phase_names``): ``inputs``, ``sort``, R x the program's step phases,
    ``fusion``, ``rows``. The fleet's step: ``forward``, ``loss``,
    ``backward``, ``optimizer``, ``metrics`` (``STEP_PHASES``). The
    single-sequence engine's step splits the network at its encoder's
    features (``NETWORK_STEP_PHASES``): ``encoder``, ``decoder``, ``loss``,
    ``loss_grad`` (from the backward's start), ``decoder_grad`` (from the
    network output's gradient), ``encoder_grad`` (from the deepest
    feature's gradient), ``optimizer``, ``metrics``. The backward's marks
    are tensor hooks (``grad_phases``), installed for the backward of a
    stamped event alone and removed after it: each stamps on the thread
    and stream the autograd engine runs that gradient on, so a captured
    graph holds it.
    On a CUDA card a mark is one thread of ``TIMESTAMP_KERNEL`` (PTX loaded
    with libcuda's ``cuModuleLoadData``: no compiler) reading
    ``%globaltimer`` and the event index from the device, launched on the
    current stream: captured into the program's graph, every replay writes
    its own row, and nothing is read to the host. On the CPU a mark is ``time.perf_counter_ns()``.
  * A program hands its call's counts to ``count`` (the caching
    allocator's device allocations and frees, its eager events:
    ``engine/refine.py::program_counts``).
  * The marks, relative to the run's first, ride in the program's final
    read of its metrics table (``read``); ``Session.finish`` makes them the
    run result's ``trace``: ``{"phases": [P names], "event_phase_ms":
    [E][P], "replayed": [E] (events that were graph replays), "span_s":
    {span name: host seconds}, "counts": {name: count}}``.

``TRACES`` keeps the newest traced runs' ``trace``, for a profiler's owner
that does not hold the runs' results. The tracing state belongs to the
process, as the profiler's does: one run at a time traces.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

PREFIX = "e2eslam."
TIMESTAMP_KERNEL = "e2eslam_timestamp"
STEP_PHASES = ("forward", "loss", "backward", "optimizer", "metrics")
NETWORK_STEP_PHASES = ("encoder", "decoder", "loss", "loss_grad", "decoder_grad",
                       "encoder_grad", "optimizer", "metrics")

TRACES: collections.deque = collections.deque(maxlen=64)

_NULL = contextlib.nullcontext()
_CURRENT: Optional["Session"] = None


def active() -> bool:
    """Whether a ``torch.profiler`` records now."""
    return bool(torch._C._autograd._profiler_enabled())


def phase_names(steps: int, step_phases: Sequence[str] = STEP_PHASES) -> List[str]:
    """The P = 4 + len(``step_phases``) ``steps`` phases of a keyframe
    event, in order."""
    return (["inputs", "sort"] + [f"{p}.{r}" for r in range(steps) for p in step_phases]
            + ["fusion", "rows"])


class Session:
    """One traced block: its spans' host seconds and, for a program run,
    its events' stamps."""

    def __init__(self):
        self.span_s: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.phases: List[str] = []
        self.replayed: List[bool] = []
        self.stamps: Optional[torch.Tensor] = None
        self.marks: Optional[np.ndarray] = None  # [E, P + 1] ns from the first, once read
        self._row: Optional[torch.Tensor] = None  # the running event's index
        self._k = 0

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with record_function(PREFIX + name):
            yield
        self.span_s[name] = self.span_s.get(name, 0.0) + time.perf_counter() - t0

    def mark(self, name: str) -> None:
        """Inside an event: stamp the start of its next phase, ``name``."""
        if self._row is None:
            return
        want = self.phases[self._k] if self._k < len(self.phases) else None
        if want is None or want.split(".")[0] != name.split(".", 1)[1]:
            raise RuntimeError(f"phase {name!r} where the event's phase {self._k} is {want!r}")
        stamp(self.stamps, self._row, self._k)
        self._k += 1

    def phase(self, name: str):
        self.mark(name)
        return self.span(name)

    @contextlib.contextmanager
    def grad_phases(self, marks: Sequence[Tuple[torch.Tensor, str]]):
        handles = [t.register_hook(lambda grad, n=name: self.mark(n)) for t, name in marks]
        try:
            yield
        finally:
            for h in handles:
                h.remove()

    @contextlib.contextmanager
    def event(self, row: torch.Tensor):
        if self.stamps is None:
            yield
            return
        if row.dtype != torch.int64 or row.device != self.stamps.device:
            raise ValueError("an event's index is an int64 tensor on the stamps' device")
        self._row, self._k = row, 0
        try:
            yield
            if self._k != len(self.phases):
                raise RuntimeError(f"the event ran {self._k} of its {len(self.phases)} phases")
            stamp(self.stamps, row, self._k)
        finally:
            self._row = None

    def begin_events(self, n_events: int, phases: Sequence[str], device: torch.device,
                     replayed: Sequence[bool]) -> None:
        self.phases = list(phases)
        self.replayed = [bool(r) for r in replayed]
        self.stamps = torch.zeros(n_events, len(self.phases) + 1, dtype=torch.int64,
                                  device=device)
        if device.type == "cuda":
            _function(device)  # loaded before any capture

    def read(self, table: torch.Tensor) -> np.ndarray:
        """``table.cpu().numpy()``, the marks riding in the same copy."""
        if self.stamps is None:
            return table.cpu().numpy()
        marks = (self.stamps - self.stamps[:1, :1]).to(table.dtype)
        flat = torch.cat([table.reshape(-1), marks.reshape(-1)]).cpu().numpy()
        self.marks = flat[table.numel():].reshape(marks.shape)
        return flat[:table.numel()].reshape(table.shape)

    def finish(self) -> Dict:
        """The run's ``trace``, also kept in ``TRACES``."""
        if self.stamps is not None and self.marks is None:
            self.marks = (self.stamps - self.stamps[:1, :1]).double().cpu().numpy()
        trace = {"phases": list(self.phases),
                 "event_phase_ms": ([] if self.marks is None
                                    else (np.diff(self.marks, axis=1) / 1e6).tolist()),
                 "replayed": list(self.replayed),
                 "span_s": dict(self.span_s),
                 "counts": dict(self.counts)}
        TRACES.append(trace)
        return trace


@contextlib.contextmanager
def session():
    """The block traced if a profiler records as it starts: yields its
    ``Session``, else None."""
    global _CURRENT
    outer = _CURRENT
    _CURRENT = Session() if active() else None
    try:
        yield _CURRENT
    finally:
        _CURRENT = outer


def span(name: str):
    """A host span of the current session; the shared null context off."""
    s = _CURRENT
    return _NULL if s is None else s.span(name)


def phase(name: str):
    """``span(name)`` that, inside a program's ``event``, also stamps the
    start of the event's next phase (``name``: ``event.<phase>`` or
    ``step.<phase>``)."""
    s = _CURRENT
    return _NULL if s is None else s.phase(name)


def event(row: torch.Tensor):
    """A keyframe event of a program whose index is ``row``: its phases
    stamp its row, and its end stamps the last mark."""
    s = _CURRENT
    return _NULL if s is None else s.event(row)


def grad_phases(*marks: Tuple[torch.Tensor, str]):
    """Around a stamped event's backward: for each ``(tensor, name)`` the
    phase ``name`` starts when ``tensor``'s gradient is complete (a hook on
    the tensor, removed at the block's end); off, or outside an event, the
    shared null context and no hook."""
    s = _CURRENT
    return _NULL if s is None or s._row is None else s.grad_phases(marks)


def begin_events(n_events: int, phases: Sequence[str], device: torch.device,
                 replayed: Sequence[bool]) -> None:
    """A program of ``n_events`` events of the phases ``phases``
    (``phase_names``) on ``device`` starts; ``replayed``: which events are
    a graph's replays."""
    s = _CURRENT
    if s is not None:
        s.begin_events(n_events, phases, device, replayed)


def count(counts: Dict[str, int]) -> None:
    """Add ``counts`` to the current session's (nothing off)."""
    s = _CURRENT
    if s is not None:
        for name, n in counts.items():
            s.counts[name] = s.counts.get(name, 0) + int(n)


def read(table: torch.Tensor) -> np.ndarray:
    """A program's final read of ``table`` (float64): ``table.cpu().numpy()``,
    with the current session's marks in the same copy."""
    s = _CURRENT
    return table.cpu().numpy() if s is None else s.read(table)


# --------------------------------------------------------------------------
# the mark
# --------------------------------------------------------------------------
def stamp(stamps: torch.Tensor, row: torch.Tensor, col: int) -> None:
    """``stamps[row, col]`` = now, in ns: ``%globaltimer`` written by the
    device in stream order on a CUDA card (``row`` read there), the host's
    ``perf_counter_ns`` on the CPU."""
    if stamps.device.type != "cuda":
        stamps[int(row.reshape(-1)[0]), col] = time.perf_counter_ns()
        return
    lib = _libcuda()
    args = (ctypes.c_void_p(stamps.data_ptr()), ctypes.c_void_p(row.data_ptr()),
            ctypes.c_uint32(stamps.shape[1]), ctypes.c_uint32(col))
    params = (ctypes.c_void_p * len(args))(*(ctypes.addressof(a) for a in args))
    with torch.cuda.device(stamps.device):
        stream = torch.cuda.current_stream(stamps.device).cuda_stream
        _check(lib, lib.cuLaunchKernel(_function(stamps.device), 1, 1, 1, 1, 1, 1, 0,
                                       ctypes.c_void_p(stream), params, None),
               "cuLaunchKernel")


# One thread: stamps[row[0] * width + col] = %globaltimer. It replaces no
# TPU kernel (the JAX package has no device timestamps): it exists so that a
# mark needs no compiler and runs inside a captured graph. Its time is the
# launch's; it loads and stores 8 bytes.
_PTX = f"""
.version 7.8
.target sm_90
.address_size 64

.visible .entry {TIMESTAMP_KERNEL}(
    .param .u64 p_stamps,
    .param .u64 p_row,
    .param .u32 p_width,
    .param .u32 p_col
)
{{
    .reg .b32 %r<3>;
    .reg .b64 %rd<10>;
    ld.param.u64 %rd1, [p_stamps];
    ld.param.u64 %rd2, [p_row];
    ld.param.u32 %r1, [p_width];
    ld.param.u32 %r2, [p_col];
    cvta.to.global.u64 %rd3, %rd1;
    cvta.to.global.u64 %rd4, %rd2;
    ld.volatile.global.u64 %rd5, [%rd4];
    cvt.u64.u32 %rd6, %r1;
    cvt.u64.u32 %rd7, %r2;
    mad.lo.u64 %rd8, %rd5, %rd6, %rd7;
    shl.b64 %rd8, %rd8, 3;
    add.u64 %rd9, %rd3, %rd8;
    mov.u64 %rd1, %globaltimer;
    st.global.u64 [%rd9], %rd1;
    ret;
}}
""".encode()

_lib: Optional[ctypes.CDLL] = None
_functions: Dict[int, ctypes.c_void_p] = {}


def _check(lib, status: int, what: str) -> None:
    if status != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(status, ctypes.byref(msg))
        raise RuntimeError(f"{what} failed: CUresult {status} "
                           f"({(msg.value or b'?').decode()})")


def _libcuda() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL("libcuda.so.1")
        vp, u = ctypes.c_void_p, ctypes.c_uint
        signatures = {
            "cuInit": [u],
            "cuGetErrorString": [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)],
            "cuCtxGetCurrent": [ctypes.POINTER(vp)],
            "cuCtxSetCurrent": [vp],
            "cuDevicePrimaryCtxRetain": [ctypes.POINTER(vp), ctypes.c_int],
            "cuModuleLoadData": [ctypes.POINTER(vp), ctypes.c_char_p],
            "cuModuleGetFunction": [ctypes.POINTER(vp), vp, ctypes.c_char_p],
            "cuLaunchKernel": [vp, u, u, u, u, u, u, u, vp, ctypes.POINTER(vp),
                               ctypes.POINTER(vp)],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _check(lib, lib.cuInit(0), "cuInit")
        _lib = lib
    return _lib


def _function(device: torch.device) -> ctypes.c_void_p:
    """The timestamp kernel, loaded into ``device``'s primary context."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    fn = _functions.get(index)
    if fn is None:
        lib = _libcuda()
        with torch.cuda.device(index):
            torch.cuda.current_stream(index)  # the runtime's context, current here
            ctx = ctypes.c_void_p()
            _check(lib, lib.cuCtxGetCurrent(ctypes.byref(ctx)), "cuCtxGetCurrent")
            if not ctx.value:
                _check(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), index),
                       "cuDevicePrimaryCtxRetain")
                _check(lib, lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
            module, fn = ctypes.c_void_p(), ctypes.c_void_p()
            _check(lib, lib.cuModuleLoadData(ctypes.byref(module), _PTX), "cuModuleLoadData")
            _check(lib, lib.cuModuleGetFunction(ctypes.byref(fn), module,
                                                TIMESTAMP_KERNEL.encode()),
                   "cuModuleGetFunction")
        _functions[index] = fn
    return fn


# --------------------------------------------------------------------------
# reading a profile
# --------------------------------------------------------------------------
def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """``(start, end)`` intervals merged where they overlap, in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    """The length ``(start, end)`` intervals cover, overlaps counted once."""
    return sum(e - s for s, e in merge(intervals))


def device_intervals(events) -> List[Tuple[float, float, str]]:
    """``(start_us, end_us, name)`` of every kernel and copy among a
    profiler's ``events()`` (annotations, which span kernels, left out)."""
    return [(e.time_range.start, e.time_range.end, e.name) for e in events
            if str(e.device_type).endswith("CUDA") and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(PREFIX)]


def stamp_clock_gaps_us(trace: Dict, device: Sequence[Tuple[float, float, str]]) -> List[float]:
    """For each replayed event of a run whose every mark the profiler saw
    (``device``: ``device_intervals`` of its profile): the first-to-last
    mark distance by the stamps minus the distance between the starts of
    the same two stamp kernels in the profiler's trace, in µs."""
    starts = sorted(s for s, _, n in device if n == TIMESTAMP_KERNEL)
    width = len(trace["phases"]) + 1
    if not trace["event_phase_ms"] or len(starts) != len(trace["event_phase_ms"]) * width:
        return []
    return [sum(ms) * 1e3 - (starts[(e + 1) * width - 1] - starts[e * width])
            for e, ms in enumerate(trace["event_phase_ms"]) if trace["replayed"][e]]
