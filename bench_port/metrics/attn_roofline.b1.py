"""The attention kernels' share of their roofline, in %: the least time an
H100 could take for every attention site of the stretch's units (UNet self-
and cross-attention of each call, the VAE mid-block's; shapes from the
configuration, ``bench_port/flops.py:attention_sites``, bound from
``bench_port/roofline.py``) over the device time of the kernels named by
`KERNELS`, the bf16 flash attention of ``csrc/flash_attention.cu``."""

from bench_port import roofline
from bench_port.flops import attention_sites
from bench_port.readers import kernel_s

KERNELS = ("flash_fwd",)


def read(rec):
    seconds = kernel_s(rec, KERNELS)
    if seconds <= 0:
        return None
    bound_ms = sum(roofline.flash_attention(b, nq, kv, h, d).bound_ms() * n
                   for b, nq, kv, h, d, n in attention_sites(rec.config,
                                                             rec.mix))
    return 100.0 * bound_ms * rec.units / (1e3 * seconds)
