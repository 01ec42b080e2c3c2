"""Tracing and per-section timing, counterpart of
``cfgpp_tpu/utils/profiling.py``.

`trace` records a ``torch.profiler`` trace (host operators, and the CUDA
kernels, copies and memsets whenever a GPU is present) and writes it as a
Chrome trace file (``*.pt.trace.json``, for Perfetto, ``chrome://tracing``
or TensorBoard's profiler plugin).  `StepTimer` times named sections on the
host clock, with the JAX class's ``summary()`` keys and ``report()`` lines.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block into ``logdir``
    (created if missing) as ``<host>_<pid>.<timestamp>.pt.trace.json``; the CPU
    activity always, the CUDA activity whenever ``torch.cuda.is_available()``.
    Yields the profiler (``key_averages()``, ``events()``).

    Usage:
        with profiling.trace("/tmp/trace"):
            engine.sample(...)
    """
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
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
