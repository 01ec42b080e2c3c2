"""SD3's MMDiT, counterpart of diffusers' `SD3Transformer2DModel` (and its
`JointTransformerBlock`) with its state-dict names, so that a checkpoint's
transformer loads one to one.

d = heads x head dim; LN is LayerNorm without affine at eps 1e-6 with its
statistics in f32; temb the conditioning vector.

- ``pos_embed``: a 2x2-stride conv of the latent, plus a fixed 2-D sin-cos
  table built on a ``pos_embed_max_size`` grid (positions ``arange(max) /
  (max / base)``, base = sample_size / patch_size; the first d/2 channels
  encode the column, the last d/2 the row; each half [sin, cos] of
  ``pos * 10000^(-k / (d/4))``), cropped at its centre to the latent's grid.
  The table is the persistent buffer ``pos_embed.pos_embed`` of diffusers'
  layout, filled by `PatchEmbed.reset_table` (a module made on the meta
  device and moved with ``to_empty`` holds no values until then).
- ``time_text_embed``: ``TimestepEmbedding(sinusoid_256(1000 sigma))`` plus
  ``Linear -> silu -> Linear`` of the pooled text vector;
  ``context_embedder``: Linear(joint_attention_dim -> d).
- each block: adaLN-Zero on both streams (``Linear(silu(temb))`` -> shift,
  scale, gate of the attention and of the MLP; ``LN(x) (1 + scale) +
  shift``), q, k, v with biases on both streams, per-head RMSNorm (weights,
  eps 1e-6) on q and k of both, ONE attention over [image tokens; text
  tokens] (scale head_dim^-1/2, no mask, the bf16 flash kernel on a CUDA
  device), split again: the image half through ``to_out``, the text half
  through ``to_add_out``; gated residuals, then ``LN (1 + scale) + shift``
  and a tanh-GELU MLP (4d) on each stream, gated.  The last block is
  ``context_pre_only``: its text norm is `AdaLayerNormContinuous` (chunked
  scale, then shift), it has no ``to_add_out`` nor ``ff_context``, and its
  text output is dropped.
- ``norm_out`` (`AdaLayerNormContinuous`), ``proj_out`` (d -> p p C), and
  unpatchify.

Latents are NHWC at `forward`, as the port's UNet takes them; the velocity
comes back in f32.  Each call goes through the module's `GraphRunner`
(``models/unet_graph.py``): the context and the pooled vector are its
static inputs, copied once a request.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cfgpp_tpu_torch.configs_sd3 import MMDiTConfig
from cfgpp_tpu_torch.kernels.flash_attention import flash_attention_hd
from cfgpp_tpu_torch.models.attention import Conv2d, Linear
from cfgpp_tpu_torch.models.unet import (TimestepEmbedding,
                                         sinusoidal_time_embed)
from cfgpp_tpu_torch.models.unet_graph import ROUTES, GraphRunner

EPS = 1e-6

# the UNet's kernel routes and this module's own name for the flash kernel
MMDIT_ROUTES = ROUTES + (("cfgpp_tpu_torch.models.mmdit",
                          ("flash_attention_hd",)),)


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine, statistics in f32."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=EPS).to(x.dtype)


def sincos_table(dim: int, grid: int, base: int) -> np.ndarray:
    """[grid * grid, dim] float64: row-major over (row, column); the first
    dim/2 channels encode the column, the last dim/2 the row."""
    pos = np.arange(grid, dtype=np.float64) / (grid / base)
    omega = 1.0 / 10000.0 ** (np.arange(dim // 4, dtype=np.float64)
                              / (dim / 4.0))

    def one(p):                                   # [grid * grid, dim / 2]
        out = np.outer(p.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)
    rows, cols = np.meshgrid(pos, pos, indexing="ij")
    return np.concatenate([one(cols), one(rows)], axis=1)


class RMSNorm(nn.Module):
    """diffusers' `RMSNorm` with a weight: statistics in f32, the
    normalized value in the input's dtype times the weight."""

    def __init__(self, dim: int, eps: float = EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().pow(2).mean(-1, keepdim=True)
        return (x.float() * torch.rsqrt(var + self.eps)).to(x.dtype) * \
            self.weight.to(x.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        d, p, m = cfg.inner_dim, cfg.patch_size, cfg.pos_embed_max_size
        self.patch_size, self.max_size = p, m
        self.base = cfg.sample_size // p
        self.proj = Conv2d(cfg.in_channels, d, p, stride=p)
        self.register_buffer("pos_embed", torch.empty(1, m * m, d))
        self.reset_table()

    @torch.no_grad()
    def reset_table(self) -> None:
        """(Re)fill the sin-cos table (float64 on the host, then the
        buffer's dtype)."""
        if self.pos_embed.is_meta:
            return
        d = self.pos_embed.shape[-1]
        table = sincos_table(d, self.max_size, self.base)
        self.pos_embed.copy_(torch.from_numpy(table)[None])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW latent -> [B, h w / p^2, d] tokens plus the cropped table."""
        h, w = x.shape[-2] // self.patch_size, x.shape[-1] // self.patch_size
        if h > self.max_size or w > self.max_size:
            raise ValueError(f"a {h}x{w} patch grid exceeds the position "
                             f"table's {self.max_size}")
        top, left = (self.max_size - h) // 2, (self.max_size - w) // 2
        table = self.pos_embed.reshape(1, self.max_size, self.max_size, -1)
        table = table[:, top:top + h, left:left + w].reshape(1, h * w, -1)
        tokens = self.proj(x).flatten(2).transpose(1, 2)
        return (tokens + table.to(tokens.dtype)).to(tokens.dtype)


class CombinedTimestepTextProjEmbeddings(nn.Module):
    def __init__(self, dim: int, pooled_dim: int):
        super().__init__()
        self.timestep_embedder = TimestepEmbedding(256, dim)
        # diffusers' PixArtAlphaTextProjection with silu: the same layers
        self.text_embedder = TimestepEmbedding(pooled_dim, dim)

    def forward(self, timestep: torch.Tensor, pooled: torch.Tensor):
        t = sinusoidal_time_embed(timestep, 256, True, 0.0).to(pooled.dtype)
        return self.timestep_embedder(t) + self.text_embedder(pooled)


class AdaLayerNormZero(nn.Module):
    """``Linear(silu(temb))`` -> (x LN-modulated for the attention, gate of
    the attention, shift, scale and gate of the MLP)."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = Linear(dim, 6 * dim)

    def forward(self, x, temb):
        shift, scale, gate, shift_mlp, scale_mlp, gate_mlp = self.linear(
            F.silu(temb))[:, None].chunk(6, dim=-1)
        return (layer_norm(x) * (1 + scale) + shift, gate, shift_mlp,
                scale_mlp, gate_mlp)


class AdaLayerNormContinuous(nn.Module):
    """``Linear(silu(temb))`` -> scale, then shift; ``LN(x) (1 + scale) +
    shift``."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = Linear(dim, 2 * dim)

    def forward(self, x, temb):
        scale, shift = self.linear(F.silu(temb))[:, None].chunk(2, dim=-1)
        return layer_norm(x) * (1 + scale) + shift


class FeedForward(nn.Module):
    """diffusers' `FeedForward(dim, activation_fn="gelu-approximate")`:
    ``net.0.proj`` (dim -> 4 dim, tanh GELU) and ``net.2`` (4 dim -> dim)."""

    def __init__(self, dim: int):
        super().__init__()
        act = nn.Module()
        act.proj = Linear(dim, 4 * dim)
        self.net = nn.ModuleList([act, nn.Identity(), Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](F.gelu(self.net[0].proj(x), approximate="tanh"))


class JointAttention(nn.Module):
    """One attention over the image and text tokens of a block."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 context_pre_only: bool):
        super().__init__()
        self.heads = heads
        self.to_q, self.to_k, self.to_v = (Linear(dim, dim) for _ in range(3))
        self.add_q_proj, self.add_k_proj, self.add_v_proj = (
            Linear(dim, dim) for _ in range(3))
        self.norm_q, self.norm_k = RMSNorm(head_dim), RMSNorm(head_dim)
        self.norm_added_q = RMSNorm(head_dim)
        self.norm_added_k = RMSNorm(head_dim)
        self.to_out = nn.ModuleList([Linear(dim, dim)])
        self.to_add_out = None if context_pre_only else Linear(dim, dim)

    def _heads_normed(self, x, norm):
        b, n, hd = x.shape
        return norm(x.reshape(b, n, self.heads, hd // self.heads)).reshape(
            b, n, hd)

    def forward(self, x, c):
        n = x.shape[1]
        q = torch.cat([self._heads_normed(self.to_q(x), self.norm_q),
                       self._heads_normed(self.add_q_proj(c),
                                          self.norm_added_q)], dim=1)
        k = torch.cat([self._heads_normed(self.to_k(x), self.norm_k),
                       self._heads_normed(self.add_k_proj(c),
                                          self.norm_added_k)], dim=1)
        v = torch.cat([self.to_v(x), self.add_v_proj(c)], dim=1)
        out = flash_attention_hd(q, k, v, self.heads)
        x_out = self.to_out[0](out[:, :n])
        c_out = None if self.to_add_out is None else self.to_add_out(
            out[:, n:])
        return x_out, c_out


class JointTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int,
                 context_pre_only: bool):
        super().__init__()
        self.context_pre_only = context_pre_only
        self.norm1 = AdaLayerNormZero(dim)
        self.norm1_context = (AdaLayerNormContinuous(dim) if context_pre_only
                              else AdaLayerNormZero(dim))
        self.attn = JointAttention(dim, heads, head_dim, context_pre_only)
        self.ff = FeedForward(dim)
        self.ff_context = None if context_pre_only else FeedForward(dim)

    def forward(self, x, c, temb):
        nx, gate, shift_mlp, scale_mlp, gate_mlp = self.norm1(x, temb)
        if self.context_pre_only:
            nc = self.norm1_context(c, temb)
        else:
            nc, c_gate, c_shift_mlp, c_scale_mlp, c_gate_mlp = \
                self.norm1_context(c, temb)
        a, ca = self.attn(nx, nc)
        x = x + gate * a
        x = x + gate_mlp * self.ff(layer_norm(x) * (1 + scale_mlp) + shift_mlp)
        if self.context_pre_only:
            return x, None
        c = c + c_gate * ca
        c = c + c_gate_mlp * self.ff_context(
            layer_norm(c) * (1 + c_scale_mlp) + c_shift_mlp)
        return x, c


class SD3Transformer2DModel(nn.Module):
    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        if cfg.qk_norm != "rms_norm" or cfg.dual_attention_layers:
            raise ValueError("the port's MMDiT has per-head RMSNorm and no "
                             "dual-attention layers (SD3.5 Large's)")
        if cfg.caption_projection_dim != cfg.inner_dim:
            raise ValueError("caption_projection_dim must equal the width")
        self.config = cfg
        d, heads = cfg.inner_dim, cfg.num_attention_heads
        self.pos_embed = PatchEmbed(cfg)
        self.time_text_embed = CombinedTimestepTextProjEmbeddings(
            d, cfg.pooled_projection_dim)
        self.context_embedder = Linear(cfg.joint_attention_dim, d)
        self.transformer_blocks = nn.ModuleList([
            JointTransformerBlock(d, heads, cfg.attention_head_dim,
                                  i == cfg.num_layers - 1)
            for i in range(cfg.num_layers)])
        self.norm_out = AdaLayerNormContinuous(d)
        self.proj_out = Linear(d, cfg.patch_size ** 2 * cfg.out_channels)
        self.graphs = GraphRunner(name="mmdit", routes=MMDIT_ROUTES)

    def forward(self, hidden_states: torch.Tensor, timestep: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                pooled_projections: torch.Tensor) -> torch.Tensor:
        """hidden_states [B, h, w, C] NHWC, timestep [B] or a scalar (1000
        sigma), encoder_hidden_states [B, tokens, joint_attention_dim],
        pooled_projections [B, pooled dim] -> the velocity [B, h, w, C],
        f32.  On a CUDA device with autograd off the call is a CUDA
        graph's replay, else `_forward_eager`."""
        return self.graphs(self._body, hidden_states, timestep,
                           encoder_hidden_states, pooled_projections)

    def _body(self, sample, timesteps, context, pooled, _time_ids=None,
              _cross_kv=None):
        """`_forward_eager` in the graph runner's calling convention."""
        return self._forward_eager(sample, timesteps, context, pooled)

    def _apply(self, fn, *args, **kwargs):
        # moved or cast parameters are new memory: no graph reads the old
        self.graphs.clear()
        return super()._apply(fn, *args, **kwargs)

    def _forward_eager(self, sample, timestep, context, pooled):
        cfg = self.config
        dtype = self.context_embedder.weight.dtype
        b, h, w, _ = sample.shape
        p = cfg.patch_size
        t = torch.as_tensor(timestep, device=sample.device).reshape(-1)
        temb = self.time_text_embed(t.expand(b) if t.numel() == 1 else t,
                                    pooled.to(dtype))
        x = self.pos_embed(sample.permute(0, 3, 1, 2).to(dtype))
        c = self.context_embedder(context.to(dtype))
        for blk in self.transformer_blocks:
            x, c = blk(x, c, temb)
        x = self.proj_out(self.norm_out(x, temb))
        x = x.reshape(b, h // p, w // p, p, p, cfg.out_channels)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, cfg.out_channels)
        return x.float()
