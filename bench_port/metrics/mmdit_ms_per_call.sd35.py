"""Device milliseconds of the operations launched inside one MMDiT call
(the harness's span around the transformer module's forward: both CFG
branches as one call of 2 rows, a CUDA graph's replay), per call, in the
profiled stretch."""

from bench_port.readers import device_ms


def read(rec):
    return device_ms(rec, "mmdit")
