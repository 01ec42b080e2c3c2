"""What the per-layer metric readers (``metrics/<name>.py``) read: the
traced run's `Record`, and helpers over it.  A reader returns None where it
finds nothing to read, and the harness then leaves the metric out."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from bench_port.trace import Trace


@dataclasses.dataclass
class Record:
    config: Dict
    mix: Dict
    units: int                      # units in each of the two stretches
    wall_s: float                   # the unprofiled stretch, host clock,
    #                                 from its start to the device idle
    window_s: float                 # the profiled stretch, the same way
    host: Dict[str, List[float]]    # host s of each span, unprofiled stretch
    trace: Trace                    # the profiled stretch


def host_ms(rec: Record, span: str) -> Optional[float]:
    """Mean host milliseconds of a span in the unprofiled stretch."""
    times = rec.host.get(span)
    return 1e3 * sum(times) / len(times) if times else None


def device_ms(rec: Record, span: str) -> Optional[float]:
    """Mean device milliseconds of the operations launched in a span."""
    times = rec.trace.spans.get(span)
    return 1e3 * sum(times) / len(times) if times else None


def kernel_s(rec: Record, patterns) -> float:
    """Device seconds of the operations whose name holds a pattern."""
    return sum(s for name, s in rec.trace.ops.items()
               if any(p in name for p in patterns))
