"""Tracing and per-section timing, counterpart of
``cfgpp_tpu/utils/profiling.py``.

`trace` records a ``torch.profiler`` trace (host operators, and the CUDA
kernels, copies and memsets whenever a GPU is present) and writes it as a
Chrome trace file (``*.pt.trace.json``, for Perfetto, ``chrome://tracing``
or TensorBoard's profiler plugin).  `StepTimer` times named sections on the
host clock, with the JAX class's ``summary()`` keys and ``report()`` lines.

The span recorder (`recording`, `span`, `unit`, `gauge`, `count`) times the
program's own layers: each unit of work (a `sample` request, a
`sample_batch` batch) gets a unit id, and every span inside it (text
encode, each solver step and UNet call, each decode, the PNG writes on the
writer's threads) carries that id, its parent, its thread, its start and
end on ``torch.profiler``'s clock and the thread's CPU time over it.  It is
off by default: then a span is one test of `ON` and a shared no-op
context, with no clock read.  While a ``torch.profiler`` is active, each
span is also a ``record_function`` range ``cfgpp.<name>``, so a Chrome
trace shows it and `attribute` can give each span the device work it
launched, the host's waits on the device inside it and the device's idle
time while it was open.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block into ``logdir``
    (created if missing) as ``<host>_<pid>.<timestamp>.pt.trace.json``; the CPU
    activity always, the CUDA activity whenever ``torch.cuda.is_available()``.
    The span recorder is on for the block (if it was off), so the trace
    holds the program's ``cfgpp.<name>`` ranges.  Yields the profiler
    (``key_averages()``, ``events()``).

    Usage:
        with profiling.trace("/tmp/trace"):
            engine.sample(...)
    """
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    spans = contextlib.nullcontext() if ON else recording()
    with spans, profile(activities=activities, on_trace_ready=
                        tensorboard_trace_handler(str(logdir))) as prof:
        yield prof


def cuda_devices(tree) -> List[torch.device]:
    """The distinct CUDA devices of the tensors in ``tree`` (a tensor, or
    lists, tuples, sets and dict values of them, nested), in order."""
    found: List[torch.device] = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda and x.device not in found:
                found.append(x.device)
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
        elif isinstance(x, (list, tuple, set, frozenset)):
            stack.extend(reversed(list(x)))
    return found


def block_until_ready(tree):
    """Wait for the device work of every CUDA tensor in ``tree`` (each
    device synchronized once; the host-side counterpart of
    ``jax.block_until_ready``); returns ``tree``.  Without a CUDA tensor it
    waits for nothing."""
    for device in cuda_devices(tree):
        torch.cuda.synchronize(device)
    return tree


class StepTimer:
    """Wall-clock section timing.

    Device synchronization happens ONLY when the caller passes ``sync_on``
    (the section's result) or times a function with `time_fn`: without it a
    section around asynchronous CUDA work measures the host's enqueue, not
    the device's completion.
    """

    def __init__(self):
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                block_until_ready(sync_on)
            self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def time_fn(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = block_until_ready(fn(*args, **kwargs))
        self.records.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self.records.items():
            out[name] = {
                "count": len(ts),
                "total_s": sum(ts),
                "mean_ms": 1000.0 * sum(ts) / len(ts),
                "min_ms": 1000.0 * min(ts),
                "max_ms": 1000.0 * max(ts),
            }
        return out

    def report(self) -> str:
        lines = []
        for name, s in self.summary().items():
            lines.append(f"{name:30s} n={s['count']:<4d} mean={s['mean_ms']:9.2f}ms "
                         f"min={s['min_ms']:9.2f}ms max={s['max_ms']:9.2f}ms")
        return "\n".join(lines)


# ------------------------------------------------------------------ spans
ON = False
"""Whether the span recorder is on: tested by every span, set only by
`start_recording` and `stop_recording`."""

PREFIX = "cfgpp."
_recording: Optional["Recording"] = None
_local = threading.local()
_span_ids = itertools.count(1)
_unit_ids = itertools.count(1)


@dataclasses.dataclass
class Span:
    """One closed span.  ``start_ns`` / ``end_ns`` are on the clock of
    ``torch.profiler``'s events (Unix epoch ns); ``cpu_ns`` is the thread's
    CPU time over the span."""
    name: str
    id: int
    unit: Optional[int]         # the unit id; None outside every unit
    parent: Optional[int]       # the enclosing span's id on this thread
    root: bool                  # opened by `unit`: the root of its unit
    thread: int                 # threading.get_native_id()
    ident: int                  # threading.get_ident()
    start_ns: int
    end_ns: int
    cpu_ns: int
    attr: Any = None


@dataclasses.dataclass
class Reading:
    """One reading of a gauge."""
    name: str
    unit: Optional[int]
    at_ns: int
    value: float


class Recording:
    """What the recorder kept from `start_recording` to `stop_recording`:
    the closed spans in the order they closed, and the gauge readings.
    Its clock is ``time.perf_counter_ns`` plus the offset to Unix time
    taken when it starts, which is ``torch.profiler``'s event clock."""

    def __init__(self):
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.spans: List[Span] = []
        self.readings: List[Reading] = []

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def subtree(self, span: Span) -> List[Span]:
        """``span`` and every span below it, on its thread."""
        children: Dict[int, List[Span]] = {}
        for s in self.spans:
            children.setdefault(s.parent, []).append(s)
        out, todo = [], [span]
        while todo:
            s = todo.pop()
            out.append(s)
            todo.extend(children.get(s.id, ()))
        return out


def start_recording() -> Recording:
    """Turn the recorder on with a new, empty `Recording`."""
    global ON, _recording
    _recording = Recording()
    ON = True
    return _recording


def stop_recording() -> Optional[Recording]:
    """Turn the recorder off; returns what it kept (None if it was off).
    A span open now still lands in that recording when it closes."""
    global ON, _recording
    ON = False
    rec, _recording = _recording, None
    return rec


@contextlib.contextmanager
def recording():
    """The recorder on for the block; yields the `Recording`."""
    rec = start_recording()
    try:
        yield rec
    finally:
        stop_recording()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack, _local.last_unit = [], None
        return _local.stack


def current_unit() -> Optional[int]:
    """The unit id of this thread's innermost open span, else of the last
    unit this thread finished (the unit whose result the caller holds)."""
    stack = _stack()
    return stack[-1].unit if stack else _local.last_unit


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("name", "attr", "unit", "root", "rec", "rf", "id", "parent",
                 "t0", "c0")

    def __init__(self, name, attr, unit, root):
        self.name, self.attr, self.unit, self.root = name, attr, unit, root

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        if self.root:
            self.unit = next(_unit_ids)
        elif self.unit is None:
            self.unit = up.unit if up is not None else _local.last_unit
        self.parent = None if up is None else up.id
        self.id = next(_span_ids)
        self.rec = _recording
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        # the wall clock read next to the range's own start and end stamps
        self.t0 = time.perf_counter_ns()
        self.c0 = time.thread_time_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t1 = time.perf_counter_ns()
        c1 = time.thread_time_ns()
        if self.root:
            _local.last_unit = self.unit
        rec = self.rec
        if rec is not None:
            rec.spans.append(Span(
                self.name, self.id, self.unit, self.parent, self.root,
                threading.get_native_id(), threading.get_ident(),
                self.t0 + rec.offset_ns, t1 + rec.offset_ns, c1 - self.c0,
                self.attr))
        return False


def span(name: str, attr: Any = None, unit: Optional[int] = None):
    """A span ``name`` (a context manager) inside the innermost open span
    of this thread; ``attr``: its attribute (a step or image index, a row
    count).  Its unit is ``unit``, else its parent's, else the last unit
    this thread finished.  With the recorder off: a shared no-op."""
    if not ON:
        return _OFF
    return _Open(name, attr, unit, False)


def unit(name: str, **attrs):
    """The root span of a new unit of work (a request, a batch), with a new
    unit id; ``attrs`` are its attributes.  With the recorder off: a
    shared no-op (the caller still builds ``attrs``, once a unit)."""
    if not ON:
        return _OFF
    return _Open(name, attrs, None, True)


def gauge(name: str, value: float) -> None:
    """One reading of gauge ``name`` (callers whose value costs something
    to compute test `ON` first)."""
    rec = _recording
    if not ON or rec is None:
        return
    rec.readings.append(Reading(name, current_unit(),
                                time.perf_counter_ns() + rec.offset_ns, value))


def count(name: str) -> None:
    """One event of counter ``name``: a reading of 1 (the UNet's graph
    runner counts each call as ``unet.replay``, ``unet.capture`` or
    ``unet.eager``)."""
    gauge(name, 1.0)


# ------------------------------------------------- spans on the device trace
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def is_host_wait(name: str) -> bool:
    """A CUDA runtime call that blocks the host until the device is done:
    a synchronize, or a synchronous ``cudaMemcpy*``."""
    return name.startswith(WAITS) or (name.startswith("cudaMemcpy")
                                      and "Async" not in name)


@dataclasses.dataclass
class Share:
    """What the device trace gives one span, not counting its children's."""
    device_s: float = 0.0   # device time of the operations launched in it
    launches: int = 0       # device operations (kernels, copies, memsets)
    waits: int = 0          # host waits on the device (`is_host_wait`)
    wait_s: float = 0.0     # host seconds inside those waits
    idle_s: float = 0.0     # device idle while it was the units' thread's
    #                         innermost open span

    def add(self, other: "Share") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


@dataclasses.dataclass
class Attribution:
    """`attribute`'s result: a `Share` a span id, the work and idle found
    outside every span, and the device's busy seconds (the union of its
    operations)."""
    spans: Dict[int, Share]
    outside: Share
    busy_s: float

    def total(self, spans: Iterable[Span]) -> Share:
        out = Share()
        for s in spans:
            out.add(self.spans.get(s.id, Share()))
        return out


class _Timeline:
    """The innermost open span of one thread over time: sorted segments
    [start, end) with its span id."""

    def __init__(self, spans: List[Span]):
        marks = sorted([(s.start_ns, 1, -s.end_ns, s.id) for s in spans]
                       + [(s.end_ns, 0, -s.start_ns, s.id) for s in spans])
        self.starts, self.ends, self.ids = [], [], []
        stack, last = [], None
        for t, opens, _, sid in marks:
            if stack and t > last:
                self.starts.append(last)
                self.ends.append(t)
                self.ids.append(stack[-1])
            if opens:
                stack.append(sid)
            else:
                stack.remove(sid)
            last = t

    def at(self, t: int) -> Optional[int]:
        i = bisect.bisect_right(self.starts, t) - 1
        return self.ids[i] if i >= 0 and t < self.ends[i] else None

    def overlaps(self, a: int, b: int):
        """(span id, ns) of each segment's overlap with [a, b)."""
        i = max(0, bisect.bisect_right(self.starts, a) - 1)
        while i < len(self.starts) and self.starts[i] < b:
            ns = min(b, self.ends[i]) - max(a, self.starts[i])
            if ns > 0:
                yield self.ids[i], ns
            i += 1


def _thread_keys(s: Span):
    """The ids the trace gives ``s``'s thread's runtime calls: its native
    id (a thread that also ran torch operators) or its pthread id cut to
    a signed 32-bit number (the PNG writer's threads, on an H100 with
    torch 2.11 and CUDA 12.8)."""
    low = s.ident & 0xFFFFFFFF
    return s.thread, (low ^ 0x80000000) - 0x80000000


def attribute(events, spans: Iterable[Span]) -> Attribution:
    """Give each span of ``spans`` (a `Recording`'s, over the same stretch
    as ``events``: ``prof.profiler.kineto_results.events()``) the device
    operations launched while it was the innermost open span of the
    launching thread (the launch is the runtime call with the device
    event's correlation id, so a CUDA graph's kernels count at its
    ``cudaGraphLaunch``), the host waits on the device made inside it, and
    the device's idle time while it was the innermost open span of the
    thread that opened the most units.  The ``record_function`` ranges'
    own device-side copies (user annotations) are not operations."""
    spans = list(spans)
    cuda = torch.autograd.DeviceType.CUDA
    launch, dev, waits = {}, [], []
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if not (e.is_user_annotation() or name.startswith(PREFIX)):
                dev.append((e.start_ns(), e.duration_ns(), e.correlation_id()))
        elif name.startswith("cu"):
            launch[e.correlation_id()] = (e.start_ns(), e.device_resource_id())
            if is_host_wait(name):
                waits.append((e.start_ns(), e.duration_ns(),
                              e.device_resource_id()))
    by_thread: Dict[int, List[Span]] = {}
    for s in spans:
        by_thread.setdefault(s.thread, []).append(s)
    lines = {t: _Timeline(v) for t, v in by_thread.items()}
    keys = {k: s.thread for s in spans for k in _thread_keys(s)}
    shares = {s.id: Share() for s in spans}
    outside = Share()

    def innermost(rid, t) -> Share:
        line = lines.get(keys.get(rid))
        sid = None if line is None else line.at(t)
        return outside if sid is None else shares[sid]

    for _, dur, corr in dev:
        at = launch.get(corr)
        share = outside if at is None else innermost(at[1], at[0])
        share.device_s += dur / 1e9
        share.launches += 1
    for start, dur, rid in waits:
        share = innermost(rid, start)
        share.waits += 1
        share.wait_s += dur / 1e9
    busy, end, gaps = 0, None, []
    for start, dur, _ in sorted(dev):
        if end is not None and start > end:
            gaps.append((end, start))
        if end is None or start > end:
            busy += dur
            end = start + dur
        elif start + dur > end:
            busy += start + dur - end
            end = start + dur
    roots: Dict[int, int] = {}
    for s in spans:
        if s.root:
            roots[s.thread] = roots.get(s.thread, 0) + 1
    main = lines[max(roots, key=roots.get)] if roots else None
    for a, b in gaps:
        covered = 0
        for sid, ns in (main.overlaps(a, b) if main is not None else ()):
            shares[sid].idle_s += ns / 1e9
            covered += ns
        outside.idle_s += (b - a - covered) / 1e9
    return Attribution(shares, outside, busy / 1e9)
