"""Int8 W8A8 layers of the opt-in quantized UNet; counterpart of
``cfgpp_tpu/models/quant.py``.

Recipe, as the JAX package's: weights symmetric per-output-channel int8,
quantized once (`quantize_kernel_int8`, `cfgpp_tpu_torch.weights.quantize`);
activations symmetric per-row dynamic int8, quantized inside the matmul
kernel; int32 accumulation, rank-1 dequant, f32 bias.  Weights keep the
torch layout ``[out, in]``; scales and biases stay f32 in every bundle.

`QuantLinear` is `QuantDense`; `QuantConv` is `QuantConv` on its 1x1 route,
which runs W8A8 through `int8_matmul` as the JAX package does on the TPU
(``cfgpp_tpu/models/quant.py:118-121``; its CPU fallback, a conv with the
dequantized weights, is not followed).  Both call the kernel wrapper, which
computes the plain version on a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cfgpp_tpu_torch.kernels.int8_matmul import int8_matmul, layernorm_ref

__all__ = ["QuantConv", "QuantLinear", "layernorm_ref", "ln_kwargs",
           "quant_dense_apply", "quantize_activation_int8",
           "quantize_kernel_int8"]


def quantize_kernel_int8(weight: torch.Tensor):
    """float [N, K] weight -> (int8 [N, K], f32 [N] per-output-channel scale)."""
    w = weight.float()
    scale = w.abs().amax(dim=1).clamp_min(1e-8) / 127.0
    wq = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return wq.to(torch.int8), scale


def quantize_activation_int8(x: torch.Tensor):
    """Per-row dynamic symmetric quantization, ``cfgpp_tpu``'s XLA recipe
    (``x / sx``; the kernels multiply by ``1/sx``).  [..., K] ->
    (int8 [..., K], f32 [..., 1] scale)."""
    xf = x.float()
    sx = xf.abs().amax(-1, keepdim=True).clamp_min(1e-6) * (1.0 / 127.0)
    xq = torch.clamp(torch.round(xf / sx), -127.0, 127.0)
    return xq.to(torch.int8), sx


def quant_dense_apply(x: torch.Tensor, weight: torch.Tensor,
                      scale: torch.Tensor, bias: Optional[torch.Tensor],
                      out_dtype: torch.dtype) -> torch.Tensor:
    """The JAX package's non-TPU W8A8 recipe: per-row activation quantize,
    exact int dot, rank-1 dequant, f32 bias.  weight int8 [N, K]."""
    xq, sx = quantize_activation_int8(x)
    acc = (xq.double() @ weight.double().t()).float()
    y = acc * sx * scale
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def ln_kwargs(ln: Optional[nn.LayerNorm]) -> dict:
    """A `LayerNorm` as the int8 kernels' fused-prologue arguments."""
    return {} if ln is None else dict(ln_scale=ln.weight, ln_bias=ln.bias,
                                      ln_eps=ln.eps)


class QuantLinear(nn.Module):
    """Int8 replacement for a `Linear`: buffers ``weight`` int8 [out, in],
    ``weight_scale`` f32 [out] and, when it has one, ``bias`` f32 [out].
    forward(x, ln=, residual=) fuses a preceding `LayerNorm` and a residual
    add into the one `int8_matmul` call; the output has x's dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight", torch.zeros(
            out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(
            out_features, dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros(
            out_features, dtype=torch.float32, device=device) if bias else None)

    @classmethod
    def from_float(cls, weight: torch.Tensor,
                   bias: Optional[torch.Tensor]) -> "QuantLinear":
        """Quantize a float [out, in] weight (and keep its bias in f32)."""
        out_f, in_f = weight.shape
        mod = cls(in_f, out_f, bias=bias is not None, device=weight.device)
        wq, scale = quantize_kernel_int8(weight)
        mod.weight.copy_(wq)
        mod.weight_scale.copy_(scale)
        if bias is not None:
            mod.bias.copy_(bias.float())
        return mod

    def forward(self, x: torch.Tensor, ln: Optional[nn.LayerNorm] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        return int8_matmul(x, self.weight, self.weight_scale, self.bias,
                           residual=residual, out_dtype=x.dtype,
                           **ln_kwargs(ln))


class QuantConv(QuantLinear):
    """Int8 1x1 convolution on NCHW images: a `QuantLinear` over the pixels
    (per-pixel activation scales, exact for a window that mixes no
    positions).  ``weight`` is [out, in]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=1,
                 bias: bool = True, device=None):
        if kernel_size not in (1, (1, 1)):
            raise NotImplementedError(
                f"int8 {kernel_size} convolutions come with the int8 "
                "mode='all' slice (cfgpp_tpu/kernels/int8_conv.py:"
                "int8_conv3x3); mode='dense' quantizes 1x1 convs only")
        super().__init__(in_channels, out_channels, bias=bias, device=device)

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, _, h, w = x.shape

        def tokens(t):
            return t.permute(0, 2, 3, 1).reshape(b, h * w, t.shape[1])

        y = super().forward(tokens(x), residual=None if residual is None
                            else tokens(residual))
        return y.reshape(b, h, w, -1).permute(0, 3, 1, 2)
