"""T5 v1.1's encoder (SD3's third text encoder), counterpart of
transformers' `T5EncoderModel` with its state-dict names (``shared``,
``encoder.block.N.layer.0.SelfAttention.q`` ...).

Each block: scale-only RMSNorm, self-attention with unscaled scores plus a
relative position bias (bucketed distances, computed once by block 0 and
shared by every block), then scale-only RMSNorm and the gated-GELU
feed-forward (tanh GELU of ``wi_0`` times ``wi_1``, then ``wo``); a final
RMSNorm.  No attention mask: SD3's pipeline runs T5 over all its padded
tokens.  The attention goes through PyTorch's SDPA with the bias as an
additive mask and the scale 1: the flash kernel takes no bias, and T5 is
about 0.3% of an SD3.5 Large request's FLOPs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cfgpp_tpu_torch.configs_sd3 import T5Config
from cfgpp_tpu_torch.models.attention import Linear


def relative_position_bucket(relative_position: torch.Tensor,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional buckets of key - query distances (transformers'
    ``T5Attention._relative_position_bucket``): half the buckets a sign;
    distances below a quarter of the buckets exact, the rest spaced
    logarithmically up to ``max_distance``, beyond which all share the last
    bucket."""
    half = num_buckets // 2
    bucket = (relative_position > 0).long() * half
    dist = relative_position.abs()
    exact = half // 2
    far = exact + (torch.log(dist.float() / exact)
                   / math.log(max_distance / exact)
                   * (half - exact)).long()
    far = torch.minimum(far, torch.full_like(far, half - 1))
    return bucket + torch.where(dist < exact, dist, far)


class T5LayerNorm(nn.Module):
    """Scale-only RMSNorm, statistics in f32."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().pow(2).mean(-1, keepdim=True)
        y = (x.float() * torch.rsqrt(var + self.eps)).to(self.weight.dtype)
        return self.weight * y


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.q = Linear(cfg.d_model, inner, bias=False)
        self.k = Linear(cfg.d_model, inner, bias=False)
        self.v = Linear(cfg.d_model, inner, bias=False)
        self.o = Linear(inner, cfg.d_model, bias=False)
        self.buckets = cfg.relative_attention_num_buckets
        self.max_distance = cfg.relative_attention_max_distance
        if has_bias:
            self.relative_attention_bias = nn.Embedding(self.buckets,
                                                        cfg.num_heads)

    def position_bias(self, n: int, dtype: torch.dtype) -> torch.Tensor:
        """[1, heads, n, n] of block 0's relative position bias."""
        table = self.relative_attention_bias
        pos = torch.arange(n, device=table.weight.device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           self.buckets, self.max_distance)
        bias = table(buckets)                            # [n, n, heads]
        return bias.permute(2, 0, 1)[None].to(dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape

        def heads(t):
            return t.reshape(b, n, self.heads, self.d_kv).transpose(1, 2)
        out = F.scaled_dot_product_attention(
            heads(self.q(x)), heads(self.k(x)), heads(self.v(x)),
            attn_mask=bias, scale=1.0)
        return self.o(out.transpose(1, 2).reshape(b, n, -1))


class T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        if cfg.feed_forward_proj != "gated-gelu":
            raise ValueError(f"T5 feed-forward {cfg.feed_forward_proj!r}: the "
                             "port has gated-gelu (T5 v1.1)")
        self.wi_0 = Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class _SelfAttentionLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)


class _FFLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_SelfAttentionLayer(cfg, has_bias),
                                    _FFLayer(cfg)])

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class _Stack(nn.Module):
    def __init__(self, cfg: T5Config, shared: nn.Embedding):
        super().__init__()
        self.embed_tokens = shared
        self.block = nn.ModuleList([T5Block(cfg, i == 0)
                                    for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model,
                                            cfg.layer_norm_epsilon)


class T5EncoderModel(nn.Module):
    """forward(input_ids [B, N]) -> the last hidden state [B, N, d_model],
    in the module's dtype."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.config = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = _Stack(cfg, self.shared)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        enc = self.encoder
        x = self.shared(input_ids)
        bias = enc.block[0].layer[0].SelfAttention.position_bias(
            input_ids.shape[1], x.dtype)
        for blk in enc.block:
            x = blk(x, bias)
        return enc.final_layer_norm(x)
