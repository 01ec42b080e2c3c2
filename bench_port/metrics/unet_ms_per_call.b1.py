"""Device milliseconds of the operations launched inside one UNet call
(the harness's span around the UNet module's forward), per call, in the
profiled stretch."""

from bench_port.readers import device_ms


def read(rec):
    return device_ms(rec, "unet")
