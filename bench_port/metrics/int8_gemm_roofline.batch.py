"""The W8A8 GEMMs' share of their roofline, in %: the least time an H100
could take for every int8 matmul of the stretch's units (``--quant dense``:
each transformer's proj_in with its GroupNorm affine and proj_out with its
residual, each layer's packed q/k/v and cross q with their LayerNorm, both
attention outputs with their residual, the GEGLU feed-forward, in every UNet
call; the cross k/v once a unit; shapes from the configuration, bounds from
``bench_port/roofline.py``) over the device time of the kernels named by
`KERNELS`, ``csrc/int8_matmul.cu``'s row quantize and GEMM."""

from bench_port import roofline
from bench_port.families.sd_unet.flops import (TOKENS, latent_hw,
                                             layers_by_level, unet_calls)
from bench_port.readers import kernel_s

KERNELS = ("quantize_rows", "gemm_s8")


def unit_bound_ms(config, mix) -> float:
    u = config["unet"]
    rows = 2 * mix["batch"]
    hw = latent_hw(config, mix)
    mm = roofline.int8_matmul
    per_call, once = 0.0, 0.0
    for level, layers in layers_by_level(u).items():
        c = u["block_out_channels"][level]
        m = rows * (hw >> level) ** 2
        blocks = layers // u["transformer_layers_per_block"][level]
        per_call += blocks * (mm(m, c, c, bias=True, affine=rows).bound_ms()
                              + mm(m, c, c, bias=True,
                                   residual=True).bound_ms())
        per_call += layers * (
            mm(m, c, 3 * c, ln=True).bound_ms()
            + 2 * mm(m, c, c, bias=True, residual=True).bound_ms()
            + mm(m, c, c, ln=True).bound_ms()
            + roofline.int8_ff_geglu(m, c).bound_ms())
        once += layers * 2 * mm(rows * TOKENS, u["cross_attention_dim"],
                                c).bound_ms()
    return unet_calls(mix) * per_call + once


def read(rec):
    if not rec.mix["quant"]:
        return None
    seconds = kernel_s(rec, KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * unit_bound_ms(rec.config, rec.mix) * rec.units / (
        1e3 * seconds)
