"""Attention primitives shared by UNet / CLIP / VAE, and the casting layers
every model of the port is built from.

Counterpart of ``cfgpp_tpu/models/attention.py``.  Every unmasked attention
goes through `cfgpp_tpu_torch.kernels.flash_attention.flash_attention_hd`
(the Hopper kernel on a CUDA tensor, its plain version on a CPU tensor), and
the int8 path's packed self-attention through `flash_attention_qkv_packed`,
or, with ``mode="all"``, through `flash_attention_qkv_packed_int8` where
`int8_score_applies`; masked attention (CLIP's causal mask) stays plain
PyTorch, as it stays XLA in the JAX package.

The JAX modules keep a compute dtype apart from the parameter dtype (the VAE
decodes with f32 parameters in bf16).  Here the compute dtype is the dtype of
the input: `Linear` and `Conv2d` cast their parameters to it, and the norms
take their statistics in f32 and return the input dtype, as flax's norms do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cfgpp_tpu_torch.kernels.flash_attention import (
    flash_attention_hd, flash_attention_qkv_packed,
    flash_attention_qkv_packed_int8, int8_score_applies)
from cfgpp_tpu_torch.models.quant import QuantLinear


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class GroupNorm(nn.GroupNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


def sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Counterpart of ``sdpa_xla``: f32 logits and softmax, additive mask,
    probabilities cast back to v's dtype.  Inputs [B, N, H, D]."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatching attention on [B, N, H, D]: unmasked -> flash kernel."""
    if mask is not None:
        return sdpa_reference(q, k, v, mask)
    b, nq, h, d = q.shape
    nkv = k.shape[1]
    out = flash_attention_hd(q.reshape(b, nq, h * d), k.reshape(b, nkv, h * d),
                             v.reshape(b, nkv, h * d), h)
    return out.reshape(b, nq, h, d)


def attention_hd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 num_heads: int, mask: Optional[torch.Tensor] = None,
                 kv_len: Optional[int] = None) -> torch.Tensor:
    """Attention on token-major [B, N, H*D] activations.  ``kv_len``: the
    valid kv rows when k/v are padded (the kernel masks the rest)."""
    if mask is None:
        return flash_attention_hd(q, k, v, num_heads, kv_len=kv_len)
    if kv_len is not None:
        k, v = k[:, :kv_len], v[:, :kv_len]
    b, n, hd = q.shape
    d = hd // num_heads
    m = k.shape[1]
    out = sdpa_reference(q.reshape(b, n, num_heads, d),
                         k.reshape(b, m, num_heads, d),
                         v.reshape(b, m, num_heads, d), mask)
    return out.reshape(b, n, hd)


class Attention(nn.Module):
    """diffusers' `Attention`: to_q/to_k/to_v without bias, to_out with bias.
    Self-attention when ``context`` is None.

    Quantized (`cfgpp_tpu_torch.weights.quantize`), the projections are
    `QuantLinear`s and self-attention's to_q/to_k/to_v are one packed
    ``to_qkv``, as in ``cfgpp_tpu/models/attention.py:_quant_forward``: the
    block's pre-LayerNorm (``ln``) rides the first projection and its
    residual add the ``to_out`` projection.  ``int8_score`` (set by
    ``quantize_unet_(mode="all")`` on self-attention) runs the score dot in
    int8 wherever `int8_score_applies`, as the JAX package's TPU route does;
    cross-attention never does."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = num_heads * head_dim
        context_dim = query_dim if context_dim is None else context_dim
        self.num_heads = num_heads
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim)])
        self.int8_score = False

    def kv(self, context: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.to_k(context), self.to_v(context)

    @property
    def quantized(self) -> bool:
        return isinstance(self.to_out[0], QuantLinear)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                kv_len: Optional[int] = None,
                cached_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                ln: Optional[nn.LayerNorm] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``cached_kv``: precomputed (k, v) of a context that is constant
        across the sampling loop (`unet.precompute_cross_kv`).  ``ln`` /
        ``residual``: the fusions of the quantized path."""
        if self.quantized:
            if mask is not None:
                raise ValueError("the quantized attention takes no mask")
            return self._quant_forward(x, context, kv_len, cached_kv, ln,
                                       residual)
        if ln is not None or residual is not None:
            raise ValueError("ln=/residual= fusion is quant-path only")
        q = self.to_q(x)
        k, v = cached_kv if cached_kv is not None else self.kv(
            x if context is None else context)
        out = attention_hd(q, k, v, self.num_heads, mask=mask, kv_len=kv_len)
        return self.to_out[0](out)

    def _quant_forward(self, x, context, kv_len, cached_kv, ln, residual):
        if context is None:
            qkv = self.to_qkv(x, ln=ln)
            d = qkv.shape[2] // 3 // self.num_heads
            if self.int8_score and int8_score_applies(qkv.shape[1],
                                                      self.num_heads, d):
                out = flash_attention_qkv_packed_int8(qkv, self.num_heads)
            else:
                out = flash_attention_qkv_packed(qkv, self.num_heads)
        else:
            q = self.to_q(x, ln=ln)
            k, v = cached_kv if cached_kv is not None else self.kv(context)
            out = flash_attention_hd(q, k, v, self.num_heads, kv_len=kv_len)
        return self.to_out[0](out, residual=residual)


class CLIPAttention(nn.Module):
    """CLIP-style MHA: biases on q/k/v/out, additive (causal) mask."""

    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(hidden_size, hidden_size)
        self.k_proj = Linear(hidden_size, hidden_size)
        self.v_proj = Linear(hidden_size, hidden_size)
        self.out_proj = Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        shape = (b, n, self.num_heads, c // self.num_heads)
        out = sdpa_reference(self.q_proj(x).reshape(shape),
                             self.k_proj(x).reshape(shape),
                             self.v_proj(x).reshape(shape), mask)
        return self.out_proj(out.reshape(b, n, c))
