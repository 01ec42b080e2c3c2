"""The traced run's reduction: from the profiler's raw events of a short
profiled stretch to the device time of each harness span, the device's busy
seconds, its idle gaps and its top operations.

Events are read in memory from ``prof.profiler.kineto_results.events()``
(no Chrome trace is written; building the profiler's Python event list for
half a million events took tens of seconds).  A device event belongs to the
innermost harness span (a ``bench.<name>`` range) that was open on the host
when it was launched: the launch is the runtime API event (``cuda*``,
``cu*``) with the device event's correlation id.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple

import torch

SPAN_PREFIX = "bench."
TOP = 10


@dataclasses.dataclass
class Trace:
    spans: Dict[str, List[float]]         # span name -> device s per span
    ops: Dict[str, float]                 # device s by operation name
    busy_s: float                         # union of device activity
    gaps: List[Tuple[str, float]]         # the `TOP` idle gaps: (span, s)
    unmatched: int                        # device events with no launch


def _innermost(spans, t):
    """The name of the innermost span of ``spans`` (sorted by start; each
    (start, end, name)) open at host time ``t``, or None."""
    best = None
    i = bisect.bisect_right([s[0] for s in spans], t)
    for start, end, name in reversed(spans[:i]):
        if start <= t <= end and (best is None or end - start < best[0]):
            best = (end - start, name)
    return None if best is None else best[1]


def reduce(prof) -> Trace:
    cuda = torch.autograd.DeviceType.CUDA
    spans, launches, dev = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(SPAN_PREFIX):
            if e.device_type() != cuda:
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              name[len(SPAN_PREFIX):]))
            continue
        if e.device_type() == cuda:
            dev.append((e.start_ns(), e.duration_ns(), name,
                        e.correlation_id()))
        elif name.startswith("cu"):
            launches[e.correlation_id()] = e.start_ns()
    spans.sort()
    leaf = {}
    for start, end, name in spans:
        leaf.setdefault(name, []).append((start, end))
    per_span: Dict[str, List[float]] = {
        name: [0.0] * len(v) for name, v in leaf.items()}
    starts = {name: [s for s, _ in v] for name, v in leaf.items()}
    unmatched = 0
    ops: Dict[str, float] = {}
    for start, dur, name, corr in dev:
        ops[name] = ops.get(name, 0.0) + dur / 1e9
        t = launches.get(corr)
        if t is None:
            unmatched += 1
            continue
        for span_name, v in leaf.items():
            i = bisect.bisect_right(starts[span_name], t) - 1
            if i >= 0 and t <= v[i][1]:
                per_span[span_name][i] += dur / 1e9
    busy, gaps, end = 0.0, [], None
    for start, dur, _, _ in sorted(dev):
        if end is not None and start > end:
            gaps.append((start - end, end))
        if end is None or start > end:
            busy += dur / 1e9
            end = start + dur
        elif start + dur > end:
            busy += (start + dur - end) / 1e9
            end = start + dur
    longest = [(_innermost(spans, at) or "between units", length / 1e9)
               for length, at in sorted(gaps, reverse=True)[:TOP]]
    return Trace(per_span, ops, busy, longest, unmatched)
