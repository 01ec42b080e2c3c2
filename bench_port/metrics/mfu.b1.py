"""The whole unit's share of the card's bf16 peak, in %: the FLOPs of the
stretch's units (``bench_port/flops.py``: text encoders, the cross k/v
once, every UNet call on both branches, the decodes) over the unprofiled
stretch's wall time x 989 TFLOP/s (H100 SXM, dense, at 700 W)."""

from bench_port.flops import unit_flops
from bench_port.roofline import BF16_FLOPS_PER_S


def read(rec):
    flops = unit_flops(rec.config, rec.mix) * rec.units
    return 100.0 * flops / (rec.wall_s * BF16_FLOPS_PER_S)
