"""Host milliseconds of one UNet call: the harness's span around the UNet
module's forward, on the host clock with no synchronisation, so the time
the host takes to enqueue the call's work (and any wait on a full launch
queue), mean over the unprofiled stretch's calls."""

from bench_port.readers import host_ms


def read(rec):
    return host_ms(rec, "unet")
