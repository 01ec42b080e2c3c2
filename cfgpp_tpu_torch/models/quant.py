"""Int8 W8A8 layers of the opt-in quantized UNet; counterpart of
``cfgpp_tpu/models/quant.py``.

Recipe, as the JAX package's: weights symmetric per-output-channel int8,
quantized once (`quantize_kernel_int8`, `quantize_conv_kernel_int8`,
`cfgpp_tpu_torch.weights.quantize`); activations symmetric dynamic int8,
quantized inside the kernels (per row in `int8_matmul`, per (sample, window
of rows) in `int8_conv3x3`); int32 accumulation, rank-1 dequant, f32 bias.
Linear weights keep the torch layout ``[out, in]``, 3x3 conv weights are
``[out, 3, 3, in]`` (the layout `int8_conv3x3` reads); scales and biases
stay f32 in every bundle.

`QuantLinear` is `QuantDense`.  `QuantConv` is `QuantConv` on the JAX
package's TPU routes (``cfgpp_tpu/models/quant.py:104-144``): a 1x1 conv
runs W8A8 through `int8_matmul`; a 3x3 conv runs `int8_conv3x3` where
`int8_conv3x3_supported` admits it, and everywhere else one conv with the
dequantized weights (plain torch, as the JAX package leaves it to XLA).
`groupnorm_silu_coeffs` folds a GroupNorm (and the resnet's time-embedding
add) into the per-(sample, channel) affine that `int8_conv3x3` applies
before its quantize (and the linear transformer's proj_in, through
`int8_matmul`'s affine prologue, without the SiLU).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cfgpp_tpu_torch.kernels.int8_conv import (int8_conv3x3,
                                               int8_conv3x3_supported)
from cfgpp_tpu_torch.kernels.int8_matmul import int8_matmul, layernorm_ref

__all__ = ["QuantConv", "QuantLinear", "groupnorm_silu_coeffs",
           "layernorm_ref", "ln_kwargs", "quantize_conv_kernel_int8",
           "quantize_kernel_int8"]


def quantize_kernel_int8(weight: torch.Tensor):
    """float [N, K] weight -> (int8 [N, K], f32 [N] per-output-channel scale)."""
    w = weight.float()
    scale = w.abs().amax(dim=1).clamp_min(1e-8) / 127.0
    wq = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return wq.to(torch.int8), scale


def quantize_conv_kernel_int8(weight: torch.Tensor):
    """float conv weight [O, I, kh, kw] (torch layout) -> (int8 [O, kh, kw,
    I], f32 [O] per-output-channel scale): the JAX function's values, in the
    layout the port's int8 convs read."""
    wq, scale = quantize_kernel_int8(
        weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1))
    o, i, kh, kw = weight.shape
    return wq.reshape(o, kh, kw, i), scale


def groupnorm_silu_coeffs(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, groups: int,
                          temb: Optional[torch.Tensor] = None,
                          eps: float = 1e-5):
    """``GroupNorm(x + temb) * gamma + beta`` as one per-(sample, channel)
    affine ``x * s + b`` (f32 [B, C] each); the SiLU follows in the
    consumer.  x NHWC [B, H, W, C]; temb [B, C] is broadcast over space.
    The group statistics of x + temb come from per-channel moments of x:
    E[x+t] = E[x] + t, E[(x+t)^2] = E[x^2] + 2 t E[x] + t^2.  f32
    statistics, biased variance, eps inside the rsqrt, as flax's GroupNorm."""
    xf = x.float()
    b, _, _, c = x.shape
    mean_c = xf.mean(dim=(1, 2))
    msq_c = (xf * xf).mean(dim=(1, 2))
    if temb is not None:
        t = temb.float()
        msq_c = msq_c + 2.0 * t * mean_c + t * t
        mean_c = mean_c + t
    else:
        t = torch.zeros((b, c), dtype=torch.float32, device=x.device)
    cg = c // groups
    mean_g = mean_c.reshape(b, groups, cg).mean(2)
    msq_g = msq_c.reshape(b, groups, cg).mean(2)
    rstd_c = torch.rsqrt(msq_g - mean_g * mean_g + eps).repeat_interleave(
        cg, dim=1)
    mu_c = mean_g.repeat_interleave(cg, dim=1)
    gam = gamma.float()[None]
    return gam * rstd_c, (t - mu_c) * rstd_c * gam + beta.float()[None]


def ln_kwargs(ln: Optional[nn.LayerNorm]) -> dict:
    """A `LayerNorm` as the int8 kernels' fused-prologue arguments."""
    return {} if ln is None else dict(ln_scale=ln.weight, ln_bias=ln.bias,
                                      ln_eps=ln.eps)


class _Int8Layer(nn.Module):
    """Buffers of an int8 layer: ``weight`` int8 of ``shape`` (output
    channels first), ``weight_scale`` f32 [out] and, when it has one,
    ``bias`` f32 [out]."""

    def __init__(self, shape, bias: bool, device):
        super().__init__()
        out = shape[0]
        self.register_buffer("weight", torch.zeros(shape, dtype=torch.int8,
                                                   device=device))
        self.register_buffer("weight_scale", torch.ones(
            out, dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros(
            out, dtype=torch.float32, device=device) if bias else None)

    def _fill(self, wq: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor]):
        self.weight.copy_(wq.reshape(self.weight.shape))
        self.weight_scale.copy_(scale)
        if bias is not None:
            self.bias.copy_(bias.float())
        return self


class QuantLinear(_Int8Layer):
    """Int8 replacement for a `Linear` (``weight`` int8 [out, in]).
    forward(x, ln=, residual=, affine=) fuses a preceding `LayerNorm` (or a
    per-(sample, channel) affine: the linear proj_in's GroupNorm) and a
    residual add into the one `int8_matmul` call; the output has x's
    dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None):
        super().__init__((out_features, in_features), bias, device)
        self.in_features, self.out_features = in_features, out_features

    @classmethod
    def placeholder(cls, weight: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> "QuantLinear":
        """An unfilled layer for a float [out, in] weight."""
        return cls(weight.shape[1], weight.shape[0], bias=bias is not None,
                   device=weight.device)

    @classmethod
    def from_float(cls, weight: torch.Tensor,
                   bias: Optional[torch.Tensor]) -> "QuantLinear":
        """Quantize a float [out, in] weight (and keep its bias in f32)."""
        return cls.placeholder(weight, bias)._fill(
            *quantize_kernel_int8(weight), bias)

    def forward(self, x: torch.Tensor, ln: Optional[nn.LayerNorm] = None,
                residual: Optional[torch.Tensor] = None,
                affine: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """``affine``: (scale, bias) f32 [B, in] of a per-(sample, channel)
        ``x*scale + bias`` ahead of the quantize (x [B, T, in])."""
        kw = ln_kwargs(ln)
        if affine is not None:
            kw.update(affine_scale=affine[0], affine_bias=affine[1])
        return int8_matmul(x, self.weight, self.weight_scale, self.bias,
                           residual=residual, out_dtype=x.dtype, **kw)


class QuantConv(_Int8Layer):
    """Int8 1x1 or 3x3 (stride 1, pad 1) convolution on NCHW images in
    channels_last memory.  ``weight`` is int8 [out, in] (1x1) or [out, 3, 3,
    in] (3x3).

    forward(x, gn_scale=, gn_bias=, residual=) takes the JAX arguments:
    ``gn_scale``/``gn_bias`` f32 [B, in] (3x3 only) are the prologue
    ``silu(x*gn_scale + gn_bias)``, ``residual`` [B, out, H, W] is added
    before the one rounding to x's dtype.  A 1x1 conv is an `int8_matmul`
    over the pixels (per-pixel scales, exact for a window that mixes no
    positions); a 3x3 conv is `int8_conv3x3` where
    `int8_conv3x3_supported` admits it and otherwise a conv with the
    weights dequantized per call (``(w_int8*scale)`` in x's dtype), as the
    JAX package's does, so the bundle holds its weights in int8 only."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=1,
                 bias: bool = True, device=None):
        ks = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
              else tuple(kernel_size))
        if ks not in ((1, 1), (3, 3)):
            raise ValueError(f"int8 convolutions are 1x1 or 3x3, not "
                             f"{kernel_size}")
        k = ks[0]
        shape = ((out_channels, in_channels) if k == 1
                 else (out_channels, 3, 3, in_channels))
        super().__init__(shape, bias, device)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = k

    @classmethod
    def placeholder(cls, weight: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> "QuantConv":
        """An unfilled layer for a float [out, in, k, k] conv weight."""
        return cls(weight.shape[1], weight.shape[0], weight.shape[-1],
                   bias=bias is not None, device=weight.device)

    @classmethod
    def from_float(cls, weight: torch.Tensor,
                   bias: Optional[torch.Tensor]) -> "QuantConv":
        """Quantize a float [out, in, k, k] conv weight (bias kept in f32)."""
        return cls.placeholder(weight, bias)._fill(
            *quantize_conv_kernel_int8(weight), bias)

    def forward(self, x: torch.Tensor, gn_scale: Optional[torch.Tensor] = None,
                gn_bias: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        xh = x.permute(0, 2, 3, 1)                       # NHWC view
        res = None if residual is None else residual.permute(0, 2, 3, 1)
        if self.kernel_size == 1:
            if gn_scale is not None:
                raise ValueError("the 1x1 route takes no GroupNorm prologue")
            b, h, w, c = xh.shape
            y = int8_matmul(xh.reshape(b, h * w, c), self.weight,
                            self.weight_scale, self.bias,
                            residual=None if res is None
                            else res.reshape(b, h * w, -1), out_dtype=x.dtype)
            return y.reshape(b, h, w, -1).permute(0, 3, 1, 2)
        if int8_conv3x3_supported(tuple(xh.shape), (1, 1), 1,
                                  self.out_channels):
            return int8_conv3x3(xh, self.weight, self.weight_scale, self.bias,
                                gn_scale, gn_bias, res,
                                out_dtype=x.dtype).permute(0, 3, 1, 2)
        return self._dequant_conv(x, gn_scale, gn_bias, residual)

    def _dequant_conv(self, x, gn_scale, gn_bias, residual) -> torch.Tensor:
        """``cfgpp_tpu/models/quant.py:113-144``: the prologue in f32, the
        weights dequantized and rounded to x's dtype, one conv whose sum
        stays f32, then + bias and + residual in f32 and one rounding to x's
        dtype, as the JAX conv's ``preferred_element_type=f32``.  The conv
        runs on f32 copies of x and the weights: a bf16 conv would round its
        sum to bf16 first.  On the card cuDNN's default TF32 for f32 convs
        keeps this exact: a bf16 value is exact in TF32, so every product is
        exact and the sum is taken in f32."""
        dt = x.dtype
        if gn_scale is not None:
            xf = x.float() * gn_scale.float()[:, :, None, None] \
                + gn_bias.float()[:, :, None, None]
            x = (xf * torch.sigmoid(xf)).to(dt)
        wf = (self.weight.float() * self.weight_scale[:, None, None, None]
              ).to(dt).permute(0, 3, 1, 2)
        y = F.conv2d(x.float(), wf.float(), padding=1)
        if self.bias is not None:
            y = y + self.bias[:, None, None]
        if residual is not None:
            y = y + residual.float()
        return y.to(dt)
