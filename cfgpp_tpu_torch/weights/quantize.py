"""Int8 weight quantization of a port UNet, in place; counterpart of
``cfgpp_tpu/weights/quantize.py:quantize_unet_params``.

``mode="dense"`` (the JAX package's default) swaps every transformer
projection for an int8 W8A8 layer: attention to_q/to_k/to_v/to_out, the
GEGLU feed-forward's ff.net.0.proj and ff.net.2, and proj_in/proj_out
(1x1-conv `QuantConv`s in the SD-1.5 layout, `QuantLinear`s in SD-2.x's
linear one).  Self-attention's to_q/to_k/to_v are packed into one
``attn1.to_qkv`` (one activation quantize, one matmul; per-output-channel
quantization commutes with the concat).  ``mode="all"`` also swaps each
resnet's conv1/conv2/conv_shortcut and each upsampler's conv
(``QUANT_CONV_NAMES``; the strided downsampler convs, conv_in and conv_out
stay float) and marks every self-attention for the int8 score.  Norms and
the time embedding stay in the bundle's dtype.  For the same float weights
the int8 values and scales are the JAX function's.

The new layers' scales and biases are f32 buffers created here, after the
bundle's dtype cast, so a bf16 bundle keeps them f32 as the JAX tree does.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from cfgpp_tpu_torch.models.quant import QuantConv, QuantLinear
from cfgpp_tpu_torch.models.unet import (BasicTransformerBlock,
                                         ResnetBlock2D, Transformer2DModel,
                                         Upsample2D)

MODES = ("dense", "all")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"quant mode must be one of {MODES}, got {mode!r}")


def _swap_(module, mode: str, make: Callable) -> None:
    """Replace the quantized sites of ``module`` (a UNet, or one of its
    blocks); ``make(cls, float weight, bias)`` builds each new layer."""
    def swap(cls, mod):
        return make(cls, mod.weight, mod.bias)

    mods = list(module.modules())
    for tr in mods:
        if isinstance(tr, Transformer2DModel):
            linear = isinstance(tr.proj_in, nn.Linear)
            proj = QuantLinear if linear else QuantConv
            tr.proj_in = swap(proj, tr.proj_in)
            tr.proj_out = swap(proj, tr.proj_out)
    for blk in mods:
        if not isinstance(blk, BasicTransformerBlock):
            continue
        a1, a2 = blk.attn1, blk.attn2
        a1.to_qkv = make(QuantLinear, torch.cat(
            [a1.to_q.weight, a1.to_k.weight, a1.to_v.weight]), None)
        del a1.to_q, a1.to_k, a1.to_v
        a1.int8_score = mode == "all"
        for name in ("to_q", "to_k", "to_v"):
            setattr(a2, name, swap(QuantLinear, getattr(a2, name)))
        for attn in (a1, a2):
            attn.to_out[0] = swap(QuantLinear, attn.to_out[0])
        blk.ff.net[0].proj = swap(QuantLinear, blk.ff.net[0].proj)
        blk.ff.net[2] = swap(QuantLinear, blk.ff.net[2])
    if mode != "all":
        return
    for m in mods:
        if isinstance(m, ResnetBlock2D):
            m.conv1 = swap(QuantConv, m.conv1)
            m.conv2 = swap(QuantConv, m.conv2)
            if m.conv_shortcut is not None:
                m.conv_shortcut = swap(QuantConv, m.conv_shortcut)
        elif isinstance(m, Upsample2D):
            m.conv = swap(QuantConv, m.conv)


@torch.no_grad()
def quantize_unet_(module, mode: str = "dense"):
    """Quantize the float weights of a UNet (or of one of its blocks) in
    place; see the module doc."""
    _check_mode(mode)
    _swap_(module, mode, lambda cls, w, b: cls.from_float(w, b))
    return module


def quantized_structure_(module, mode: str = "dense"):
    """Swap in the quantized layers with placeholder values, for loading a
    quantized state dict (the JAX package's ``quantized(mode).params()``)."""
    _check_mode(mode)
    _swap_(module, mode, lambda cls, w, b: cls.placeholder(w, b))
    return module
