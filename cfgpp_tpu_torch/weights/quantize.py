"""Int8 weight quantization of a port UNet, in place; counterpart of
``cfgpp_tpu/weights/quantize.py:quantize_unet_params``.

``mode="dense"`` (the JAX package's default) swaps every transformer
projection for an int8 W8A8 layer: attention to_q/to_k/to_v/to_out, the
GEGLU feed-forward's ff.net.0.proj and ff.net.2, and the 1x1-conv
proj_in/proj_out.  Self-attention's to_q/to_k/to_v are packed into one
``attn1.to_qkv`` (one activation quantize, one matmul; per-output-channel
quantization commutes with the concat).  Convolutions, norms and the time
embedding stay in the bundle's dtype.  For the same float weights the int8
values and scales are the JAX function's.

The new layers' scales and biases are f32 buffers created here, after the
bundle's dtype cast, so a bf16 bundle keeps them f32 as the JAX tree does.
"""

from __future__ import annotations

from typing import Callable

import torch

from cfgpp_tpu_torch.models.quant import QuantConv, QuantLinear
from cfgpp_tpu_torch.models.unet import (BasicTransformerBlock,
                                         Transformer2DModel)

MODES = ("dense",)


def _check_mode(mode: str) -> None:
    if mode == "all":
        raise NotImplementedError(
            "quant mode 'all' (int8 resnet convs and int8-score attention) "
            "comes with its own slice of the port; 'dense' is supported")
    if mode not in MODES:
        raise ValueError(f"quant mode must be one of {MODES}, got {mode!r}")


def _swap_(module, make: Callable) -> None:
    """Replace the quantized sites of ``module`` (a UNet, or one of its
    transformers or transformer blocks); ``make(cls, weight [out, in],
    bias)`` builds each new layer."""
    def swap(cls, mod):
        return make(cls, mod.weight.reshape(mod.weight.shape[0], -1), mod.bias)

    mods = list(module.modules())
    for tr in mods:
        if isinstance(tr, Transformer2DModel):
            tr.proj_in = swap(QuantConv, tr.proj_in)
            tr.proj_out = swap(QuantConv, tr.proj_out)
    for blk in mods:
        if not isinstance(blk, BasicTransformerBlock):
            continue
        a1, a2 = blk.attn1, blk.attn2
        a1.to_qkv = make(QuantLinear, torch.cat(
            [a1.to_q.weight, a1.to_k.weight, a1.to_v.weight]), None)
        del a1.to_q, a1.to_k, a1.to_v
        for name in ("to_q", "to_k", "to_v"):
            setattr(a2, name, swap(QuantLinear, getattr(a2, name)))
        for attn in (a1, a2):
            attn.to_out[0] = swap(QuantLinear, attn.to_out[0])
        blk.ff.net[0].proj = swap(QuantLinear, blk.ff.net[0].proj)
        blk.ff.net[2] = swap(QuantLinear, blk.ff.net[2])


@torch.no_grad()
def quantize_unet_(module, mode: str = "dense"):
    """Quantize the float weights of a UNet (or of one of its transformers
    or blocks) in place; see the module doc."""
    _check_mode(mode)
    _swap_(module, lambda cls, w, b: cls.from_float(w, b))
    return module


def quantized_structure_(module, mode: str = "dense"):
    """Swap in the quantized layers with placeholder values, for loading a
    quantized state dict (the JAX package's ``quantized(mode).params()``)."""
    _check_mode(mode)
    _swap_(module, lambda cls, w, b: cls(w.shape[1], w.shape[0],
                                         bias=b is not None, device=w.device))
    return module
