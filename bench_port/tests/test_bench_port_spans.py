"""The harness's reduction beside the program's own spans, and the text
encoders' readers, on synthetic profiler events (CPU, no card).

With the port's span recorder on under the profiler, the trace also holds
its host ranges ``cfgpp.<name>``, which nest inside or around the
harness's ``bench.<name>`` ranges: `trace.reduce` reads the same numbers
from such a trace as from one without them."""

import dataclasses
import types

import torch

from bench_port import readers, trace
from bench_port.manifest import reader

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, start, dur, corr=0, device=CPU):
        self._v = (name, start, dur, corr, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]


def profiler(events):
    results = types.SimpleNamespace(events=lambda: list(events))
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


HARNESS = [
    Event("bench.unit", 0, 2000),
    Event("bench.text", 10, 300),
    Event("cudaMemcpyAsync", 20, 5, corr=1),
    Event("cudaLaunchKernel", 100, 5, corr=2),
    Event("bench.unet", 400, 600),
    Event("cudaLaunchKernel", 450, 5, corr=3),
    Event("cudaLaunchKernel", 500, 5, corr=4),
    Event("bench.vae", 1200, 500),
    Event("cudaLaunchKernel", 1300, 5, corr=5),
    Event("Memcpy HtoD", 30, 10, corr=1, device=CUDA),
    Event("sgemm", 120, 200, corr=2, device=CUDA),
    Event("k1", 460, 300, corr=3, device=CUDA),
    Event("k2", 800, 300, corr=4, device=CUDA),
    Event("conv", 1310, 400, corr=5, device=CUDA),
]
PROGRAM = [                     # the port's host ranges, CPU side
    Event("cfgpp.batch", 5, 1990),
    Event("cfgpp.text", 12, 290),
    Event("cfgpp.tokenize", 15, 20),
    Event("cfgpp.step", 390, 620),
    Event("cfgpp.unet", 395, 610),
    Event("cfgpp.decode", 1190, 520),
]


def test_reduce_reads_the_same_with_the_program_ranges():
    alone = trace.reduce(profiler(HARNESS))
    both = trace.reduce(profiler(HARNESS + PROGRAM))
    assert dataclasses.asdict(both) == dataclasses.asdict(alone)
    assert alone.spans["text"] == [210e-9]
    assert alone.spans["unet"] == [600e-9]
    assert alone.unmatched == 0


def _record(spans, units=2):
    tr = trace.Trace(spans=spans, ops={}, busy_s=1.0, gaps=[], unmatched=0)
    return readers.Record(config={}, mix={"quant": None}, units=units,
                          wall_s=2.0, window_s=2.5, host={}, trace=tr)


def test_text_readers():
    for name in ("text_ms_per_unit.b1", "text_ms_per_unit.batch"):
        read = reader(name)
        assert read(_record({})) is None
        assert read(_record({"unet": [0.1]})) is None
        got = read(_record({"text": [0.01, 0.002, 0.012, 0.001]}))
        assert abs(got - 12.5) < 1e-9
