"""UNet2DConditionModel, SD-1.5, SD-2.x and SDXL layouts; counterpart of
``cfgpp_tpu/models/unet.py``.

Module names follow the diffusers state-dict layout.  The public layout is
the JAX package's: NHWC latents in, NHWC f32 eps out, token-major
``[B, N, H*D]`` at attention.  Inside, an NHWC tensor seen through
``.permute(0, 3, 1, 2)`` is an NCHW tensor in channels_last memory, which
the convolutions take as it is, and the way back to tokens is a view.
Parameters are in the compute dtype (bf16 on the card); norms keep f32
statistics.

Covered: the `Transformer2DModel` in both layouts, SD-1.5's 1x1-conv
projections and SD-2.x's linear projections (``use_linear_projection``:
GroupNorm, the tokens view, ``Linear`` proj_in, the blocks, ``Linear``
proj_out, the image view plus the residual), exact and int8
``mode="dense"`` and ``mode="all"`` (`cfgpp_tpu_torch.weights.quantize`
swaps the transformer projections for `QuantLinear`/`QuantConv`; the
blocks below then take the JAX package's quant plumbing: each
pre-LayerNorm rides the first int8 matmul of its sublayer, each residual
the last.  A linear proj_in takes the transformer's GroupNorm as the
per-(sample, channel) ``affine`` prologue of its `int8_matmul`, and the
linear proj_out the transformer's input as its fused residual.
``mode="all"`` also swaps the resnet convs and the upsampler conv, and the
resnet folds each GroupNorm + SiLU into its conv's prologue, the time
embedding into norm2's coefficients and the skip add into conv2's
epilogue).  SDXL's ``text_time`` added embedding
(``cfgpp_tpu/models/unet.py:414-427``): the 6 micro-conditioning ids each
embedded sinusoidally, flattened and concatenated in f32 after the pooled
text embeds, cast to the UNet's dtype and run through ``add_embedding``,
whose output is added to the time embedding.  It stays exact under
``--quant``, as in the JAX tree.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cfgpp_tpu_torch.configs import UNetConfig
from cfgpp_tpu_torch.kernels.int8_matmul import int8_ff_geglu
from cfgpp_tpu_torch.models.attention import (Attention, Conv2d, GroupNorm,
                                              LayerNorm, Linear)
from cfgpp_tpu_torch.models.quant import (QuantConv, QuantLinear,
                                          groupnorm_silu_coeffs, ln_kwargs)
from cfgpp_tpu_torch.models.unet_graph import GraphRunner

CrossKV = Dict[str, List[Tuple[torch.Tensor, torch.Tensor]]]


def sinusoidal_time_embed(timesteps: torch.Tensor, dim: int,
                          flip_sin_to_cos: bool = True,
                          freq_shift: float = 0.0,
                          max_period: float = 10000.0) -> torch.Tensor:
    """diffusers `get_timestep_embedding` semantics; f32.  [B] -> [B, dim]."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / (half - freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last) -> [B, H*W, C]; a view for channels_last input."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def _image(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H*W, C] -> NCHW in channels_last memory (a view)."""
    b, _, c = x.shape
    return x.reshape(b, h, w, c).permute(0, 3, 1, 2)


class TimestepEmbedding(nn.Module):
    """linear_1 -> silu -> linear_2 (diffusers `TimestepEmbedding`)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, out_dim)
        self.linear_2 = Linear(out_dim, out_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_dim: int, groups: int,
                 eps: float):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = Linear(temb_dim, out_ch)
        self.norm2 = GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, temb):
        t = self.time_emb_proj(F.silu(temb))
        if isinstance(self.conv1, QuantConv):
            return self._quant_forward(x, t)
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + t[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h

    def _quant_forward(self, x, t):
        """``cfgpp_tpu/models/unet.py:69-93``: norm1 and norm2 (with the
        time embedding) as per-(sample, channel) affines from one statistics
        pass each, applied with the SiLU inside conv1 and conv2; the skip
        add in conv2's epilogue."""
        n1, n2 = self.norm1, self.norm2

        def coeffs(norm, h, temb=None):
            return groupnorm_silu_coeffs(h.permute(0, 2, 3, 1), norm.weight,
                                         norm.bias, norm.num_groups,
                                         temb=temb, eps=norm.eps)

        s1, c1 = coeffs(n1, x)
        h = self.conv1(x, gn_scale=s1, gn_bias=c1)
        s2, c2 = coeffs(n2, h, t)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return self.conv2(h, gn_scale=s2, gn_bias=c2, residual=x)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        x_p, gate = self.proj(x).chunk(2, dim=-1)
        return x_p * F.gelu(gate)   # erf gelu, as diffusers' GEGLU


class FeedForward(nn.Module):
    """GEGLU feed-forward: diffusers ff.net.0.proj + ff.net.2."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(),
                                  Linear(inner, dim)])

    def forward(self, x, ln=None, residual=None):
        w1, w2 = self.net[0].proj, self.net[2]
        if isinstance(w2, QuantLinear):
            # the whole block in one call: pre-LN, GEGLU, requantize of the
            # f32 hidden state, second dot, residual
            return int8_ff_geglu(x, w1.weight, w1.weight_scale, w1.bias,
                                 w2.weight, w2.weight_scale, w2.bias,
                                 residual=residual, out_dtype=x.dtype,
                                 **ln_kwargs(ln))
        if ln is not None or residual is not None:
            raise ValueError("ln=/residual= fusion is quant-path only")
        return w2(self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, head_dim: int, ctx_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, num_heads, head_dim)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, num_heads, head_dim, ctx_dim)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context, kv_len=None, cached_kv=None):
        if self.attn1.quantized:
            x = self.attn1(x, ln=self.norm1, residual=x)
            x = self.attn2(x, context, kv_len=kv_len, cached_kv=cached_kv,
                           ln=self.norm2, residual=x)
            return self.ff(x, ln=self.norm3, residual=x)
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context, kv_len=kv_len,
                           cached_kv=cached_kv)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """Spatial transformer: 1x1-conv projections (SD-1.5) or, with
    ``linear``, linear ones over the tokens (SD-2.x,
    ``cfgpp_tpu/models/unet.py:190-275``)."""

    def __init__(self, ch: int, num_heads: int, head_dim: int, num_layers: int,
                 ctx_dim: int, groups: int, linear: bool = False):
        super().__init__()
        inner = num_heads * head_dim
        self.norm = GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = Linear(ch, inner) if linear else Conv2d(ch, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, num_heads, head_dim, ctx_dim)
             for _ in range(num_layers)])
        self.proj_out = Linear(inner, ch) if linear else Conv2d(inner, ch, 1)

    def forward(self, x, context, kv_len=None, cross_kv=None):
        h, w = x.shape[2:]
        t = self._project_in(x)
        for i, blk in enumerate(self.transformer_blocks):
            t = blk(t, context, kv_len=kv_len,
                    cached_kv=None if cross_kv is None else cross_kv[i])
        if isinstance(self.proj_out, QuantLinear):
            return _image(self.proj_out(t, residual=_tokens(x)), h, w)
        if isinstance(self.proj_out, nn.Linear):
            return _image(self.proj_out(t), h, w) + x
        if isinstance(self.proj_out, QuantConv):
            return self.proj_out(_image(t, h, w), residual=x)
        return self.proj_out(_image(t, h, w)) + x

    def _project_in(self, x):
        """GroupNorm and proj_in -> tokens [B, H*W, inner].  An int8 linear
        proj_in takes the GroupNorm as its `int8_matmul`'s per-(sample,
        channel) affine prologue (``cfgpp_tpu/models/unet.py:210-230``):
        one statistics pass, no normalized copy, and no SiLU."""
        if isinstance(self.proj_in, QuantLinear):
            n = self.norm
            s, b = groupnorm_silu_coeffs(x.permute(0, 2, 3, 1), n.weight,
                                         n.bias, n.num_groups, eps=n.eps)
            return self.proj_in(_tokens(x), affine=(s, b))
        if isinstance(self.proj_in, nn.Linear):
            return self.proj_in(_tokens(self.norm(x)))
        return _tokens(self.proj_in(self.norm(x)))


class Downsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block(nn.Module):
    """Holder giving diffusers' down_blocks.N / up_blocks.N / mid_block names."""


class UNet2DConditionModel(nn.Module):
    """The noise-prediction network.  forward(sample [B,H,W,4] NHWC, t [B] or
    scalar, context [B,77,cross_dim]) -> eps (v with ``prediction_type``
    "v_prediction"; the engine converts it) [B,H,W,4] f32."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        if cfg.addition_embed_type not in (None, "text_time"):
            raise ValueError(f"addition_embed_type {cfg.addition_embed_type!r}"
                             ": the port covers None (SD) and 'text_time' "
                             "(SDXL)")
        self.config = cfg
        b0 = cfg.block_out_channels[0]
        temb = cfg.time_embed_dim
        self.conv_in = Conv2d(cfg.in_channels, b0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(b0, temb)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb)

        def resnet(i, o):
            return ResnetBlock2D(i, o, temb, cfg.norm_num_groups, cfg.norm_eps)

        def transformer(ch, level):
            heads = cfg.num_attention_heads[level]
            return Transformer2DModel(ch, heads, ch // heads,
                                      cfg.transformer_layers_per_block[level],
                                      cfg.cross_attention_dim,
                                      cfg.norm_num_groups,
                                      linear=cfg.use_linear_projection)

        n_blocks = len(cfg.block_out_channels)
        ch, skips = b0, [b0]
        self.down_blocks = nn.ModuleList()
        for i, (btype, out_ch) in enumerate(zip(cfg.down_block_types,
                                                cfg.block_out_channels)):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            if btype == "CrossAttnDownBlock2D":
                blk.attentions = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(resnet(ch, out_ch))
                ch = out_ch
                if btype == "CrossAttnDownBlock2D":
                    blk.attentions.append(transformer(out_ch, i))
                skips.append(ch)
            if i < n_blocks - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(out_ch)])
                skips.append(ch)
            self.down_blocks.append(blk)

        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList([resnet(ch, ch), resnet(ch, ch)])
        self.mid_block.attentions = nn.ModuleList([transformer(ch, n_blocks - 1)])

        rev = list(reversed(cfg.block_out_channels))
        self.up_blocks = nn.ModuleList()
        for i, btype in enumerate(cfg.up_block_types):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            if btype == "CrossAttnUpBlock2D":
                blk.attentions = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(resnet(ch + skips.pop(), rev[i]))
                ch = rev[i]
                if btype == "CrossAttnUpBlock2D":
                    blk.attentions.append(transformer(ch, n_blocks - 1 - i))
            if i < n_blocks - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(blk)

        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch, eps=cfg.norm_eps)
        self.conv_out = Conv2d(ch, cfg.out_channels, 3, padding=1)
        for name, tr in self.cross_attention_sites():
            tr.site = name
        self.graphs = GraphRunner()

    def cross_attention_sites(self):
        """(site name, Transformer2DModel) in the JAX package's site naming."""
        for i, blk in enumerate(self.down_blocks):
            for j, t in enumerate(getattr(blk, "attentions", [])):
                yield f"down_blocks_{i}_attentions_{j}", t
        yield "mid_block_attentions_0", self.mid_block.attentions[0]
        for i, blk in enumerate(self.up_blocks):
            for j, t in enumerate(getattr(blk, "attentions", [])):
                yield f"up_blocks_{i}_attentions_{j}", t

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                added_text_embeds: Optional[torch.Tensor] = None,
                added_time_ids: Optional[torch.Tensor] = None,
                cross_kv: Optional[CrossKV] = None) -> torch.Tensor:
        """``cross_kv``: {site: [(k, v) per layer]} from `precompute_cross_kv`;
        each cross-attention site then skips its to_k/to_v projections.
        SDXL: ``added_text_embeds`` [B, pooled dim] (encoder 2's projected
        pooled output) and ``added_time_ids`` [B, 6].  On a CUDA device with
        autograd off the call is a CUDA graph's replay
        (`cfgpp_tpu_torch.models.unet_graph`), else `_forward_eager`."""
        return self.graphs(self._forward_eager, sample, timesteps,
                           encoder_hidden_states, added_text_embeds,
                           added_time_ids, cross_kv)

    def _apply(self, fn, *args, **kwargs):
        # moved or cast parameters are new memory: no graph reads the old
        self.graphs.clear()
        return super()._apply(fn, *args, **kwargs)

    def _forward_eager(self, sample, timesteps, encoder_hidden_states,
                       added_text_embeds, added_time_ids, cross_kv):
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        b = sample.shape[0]
        t = torch.as_tensor(timesteps, device=sample.device).expand(b)
        emb = self.time_embedding(sinusoidal_time_embed(
            t, cfg.block_out_channels[0], cfg.flip_sin_to_cos,
            cfg.freq_shift).to(dtype))
        if cfg.addition_embed_type == "text_time":
            if added_text_embeds is None or added_time_ids is None:
                raise ValueError("SDXL UNet requires added_text_embeds and "
                                 "added_time_ids")
            ids = sinusoidal_time_embed(
                added_time_ids.reshape(-1), cfg.addition_time_embed_dim,
                cfg.flip_sin_to_cos, cfg.freq_shift).reshape(b, -1)
            add_in = torch.cat([added_text_embeds.float(), ids], dim=-1)
            emb = emb + self.add_embedding(add_in.to(dtype))
        context = encoder_hidden_states.to(dtype)
        kv_len = context.shape[1]

        def attend(tr, x):
            ckv = None if cross_kv is None else cross_kv[tr.site]
            return tr(x, context, kv_len=kv_len, cross_kv=ckv)

        x = self.conv_in(sample.permute(0, 3, 1, 2).to(dtype))
        res_stack = [x]
        for blk in self.down_blocks:
            attns = getattr(blk, "attentions", None)
            for j, r in enumerate(blk.resnets):
                x = r(x, emb)
                if attns is not None:
                    x = attend(attns[j], x)
                res_stack.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                res_stack.append(x)

        x = self.mid_block.resnets[0](x, emb)
        x = attend(self.mid_block.attentions[0], x)
        x = self.mid_block.resnets[1](x, emb)

        for blk in self.up_blocks:
            attns = getattr(blk, "attentions", None)
            for j, r in enumerate(blk.resnets):
                x = r(torch.cat([x, res_stack.pop()], dim=1), emb)
                if attns is not None:
                    x = attend(attns[j], x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)

        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.permute(0, 2, 3, 1).float()


def precompute_cross_kv(unet: UNet2DConditionModel,
                        context: torch.Tensor) -> CrossKV:
    """Every cross-attention site's (k, v) from the text context.

    The kv projections read only the context, which is constant across the
    sampling loop; the engine computes them once per request instead of in
    each of the NFE UNet calls.  Same projections as the uncached forward,
    so a cached forward equals an uncached one."""
    ctx = context.to(unet.conv_in.weight.dtype)
    return {name: [blk.attn2.kv(ctx) for blk in tr.transformer_blocks]
            for name, tr in unet.cross_attention_sites()}
