"""Device milliseconds of the operations launched inside one VAE decode
(the harness's span around ``vae.decode``; the engine decodes image by
image), per image, in the profiled stretch."""

from bench_port.readers import device_ms


def read(rec):
    return device_ms(rec, "vae")
