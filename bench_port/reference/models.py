"""Plain float32 CLIP text encoder, UNet and VAE decoder of the SD and SDXL
families, for the benchmark's reference.

Written from the published architectures (diffusers' `UNet2DConditionModel`
and `AutoencoderKL`, transformers' `CLIPTextModel`), with their state-dict
names, so that the benchmark's weight generator fills them as it fills the
program's modules.  NCHW inside; latents and images are NHWC at the public
functions, as the program's are.  Attention is softmax(q k^T / sqrt(d)) v
on whole matrices.  No kernel, no cache: cross-attention k and v are
computed in every call.  Every product goes through the module's `ops`
(`ops.F32`, or a control), set by `set_ops`; the linear layers that
`mark_quant_sites` marks compute the program's W8A8 recipe.

Configurations are the benchmark's JSON files (``configs/<name>.json``):
the keys of diffusers' and transformers' config files.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bench_port.reference.ops import F32, Ops


def set_ops(model: nn.Module, ops: Ops) -> nn.Module:
    for m in model.modules():
        m.ops = ops
    return model


class _Mod(nn.Module):
    ops = F32


class Linear(nn.Linear):
    ops = F32
    quant = False

    def forward(self, x):
        if self.quant:
            return self.ops.quantized_linear(x, self.weight, self.bias)
        return self.ops.linear(x, self.weight, self.bias)


class Conv2d(nn.Conv2d):
    ops = F32

    def forward(self, x):
        return self.ops.conv2d(x, self.weight, self.bias, self.stride,
                               self.padding)


def mark_quant_sites(unet: nn.Module, mode: str) -> None:
    """The W8A8 sites of the program's ``quantize_unet_(mode)``: ``dense``
    is every transformer projection (proj_in, proj_out, attention q, k, v
    and out, the GEGLU feed-forward's two layers)."""
    if mode != "dense":
        raise ValueError(f"the reference has no quant mode {mode!r}")
    for m in unet.modules():
        if isinstance(m, Transformer):
            if not m.linear:
                raise ValueError("the reference's W8A8 covers the linear "
                                 "projections (SD-2.x, SDXL), not 1x1 convs")
            m.proj_in.quant = m.proj_out.quant = True
        elif isinstance(m, Block):
            for a in (m.attn1, m.attn2):
                for layer in (a.to_q, a.to_k, a.to_v, a.to_out[0]):
                    layer.quant = True
            m.ff.net[0].proj.quant = m.ff.net[2].quant = True


def group_norm(norm: nn.GroupNorm, x):
    return F.group_norm(x, norm.num_groups, norm.weight, norm.bias, norm.eps)


def attention(ops: Ops, q, k, v, heads: int, mask=None):
    """q [B, N, H*D], k/v [B, M, H*D] -> [B, N, H*D]."""
    b, n, hd = q.shape
    m, d = k.shape[1], hd // heads
    qh = q.reshape(b, n, heads, d).transpose(1, 2)
    kh = k.reshape(b, m, heads, d).transpose(1, 2)
    vh = v.reshape(b, m, heads, d).transpose(1, 2)
    logits = ops.matmul(qh, kh.transpose(-1, -2)) * d ** -0.5
    if mask is not None:
        logits = logits + mask
    out = ops.matmul(torch.softmax(logits, dim=-1), vh)
    return out.transpose(1, 2).reshape(b, n, hd)


def ns(d: dict) -> SimpleNamespace:
    return SimpleNamespace(**d)


# --------------------------------------------------------------------- CLIP
class CLIPLayer(_Mod):
    def __init__(self, c):
        super().__init__()
        h = c.hidden_size
        self.heads = c.num_heads
        self.act = c.hidden_act
        self.self_attn = _Mod()
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, p, Linear(h, h))
        self.layer_norm1 = nn.LayerNorm(h, eps=c.layer_norm_eps)
        self.mlp = _Mod()
        self.mlp.fc1 = Linear(h, c.intermediate_size)
        self.mlp.fc2 = Linear(c.intermediate_size, h)
        self.layer_norm2 = nn.LayerNorm(h, eps=c.layer_norm_eps)

    def forward(self, x, mask):
        a, y = self.self_attn, self.layer_norm1(x)
        x = x + a.out_proj(attention(self.ops, a.q_proj(y), a.k_proj(y),
                                     a.v_proj(y), self.heads, mask))
        y = self.mlp.fc1(self.layer_norm2(x))
        y = y * torch.sigmoid(1.702 * y) if self.act == "quick_gelu" \
            else F.gelu(y)
        return x + self.mlp.fc2(y)


class CLIPText(_Mod):
    """Returns (last hidden state, penultimate hidden state, pooled)."""

    def __init__(self, c):
        super().__init__()
        c = ns(c)
        self.eos = c.eos_token_id
        tm = self.text_model = _Mod()
        tm.embeddings = _Mod()
        tm.embeddings.token_embedding = nn.Embedding(c.vocab_size,
                                                     c.hidden_size)
        tm.embeddings.position_embedding = nn.Embedding(
            c.max_position_embeddings, c.hidden_size)
        tm.encoder = _Mod()
        tm.encoder.layers = nn.ModuleList(
            [CLIPLayer(c) for _ in range(c.num_layers)])
        tm.final_layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.text_projection = (Linear(c.hidden_size, c.projection_dim,
                                       bias=False)
                                if c.projection_dim else None)

    def forward(self, ids: torch.Tensor):
        tm = self.text_model
        b, n = ids.shape
        x = tm.embeddings.token_embedding(ids) + \
            tm.embeddings.position_embedding.weight[:n][None]
        mask = torch.full((n, n), float("-inf"), device=x.device).triu(1)
        hidden = [x]
        for layer in tm.encoder.layers:
            x = layer(x, mask[None, None])
            hidden.append(x)
        last = tm.final_layer_norm(x)
        eos = (ids == self.eos).int().argmax(dim=-1)
        pooled = last[torch.arange(b, device=x.device), eos]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return last, hidden[-2], pooled


# --------------------------------------------------------------------- UNet
def timestep_embedding(t: torch.Tensor, dim: int, flip: bool,
                       shift: float) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - shift))
    arg = t.float()[:, None] * freqs[None]
    sin, cos = torch.sin(arg), torch.cos(arg)
    return torch.cat([cos, sin] if flip else [sin, cos], dim=-1)


class MLP2(_Mod):
    """linear_1 -> silu -> linear_2."""

    def __init__(self, i, o):
        super().__init__()
        self.linear_1 = Linear(i, o)
        self.linear_2 = Linear(o, o)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class Resnet(_Mod):
    def __init__(self, i, o, temb, groups, eps):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, i, eps=eps)
        self.conv1 = Conv2d(i, o, 3, padding=1)
        if temb:
            self.time_emb_proj = Linear(temb, o)
        self.norm2 = nn.GroupNorm(groups, o, eps=eps)
        self.conv2 = Conv2d(o, o, 3, padding=1)
        self.conv_shortcut = Conv2d(i, o, 1) if i != o else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(group_norm(self.norm1, x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(group_norm(self.norm2, h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attn(_Mod):
    def __init__(self, dim, heads, ctx_dim=None):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(ctx_dim or dim, dim, bias=False)
        self.to_v = Linear(ctx_dim or dim, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim)])

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        return self.to_out[0](attention(self.ops, self.to_q(x), self.to_k(ctx),
                                        self.to_v(ctx), self.heads))


class Block(_Mod):
    def __init__(self, dim, heads, ctx_dim):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attn(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attn(dim, heads, ctx_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = _Mod()
        geglu = _Mod()
        geglu.proj = Linear(dim, dim * 8)
        self.ff.net = nn.ModuleList([geglu, nn.Identity(),
                                     Linear(dim * 4, dim)])

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        h, gate = self.ff.net[0].proj(self.norm3(x)).chunk(2, dim=-1)
        return x + self.ff.net[2](h * F.gelu(gate))


class Transformer(_Mod):
    def __init__(self, ch, heads, layers, ctx_dim, groups, linear):
        super().__init__()
        self.linear = linear
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = Linear(ch, ch) if linear else Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList(
            [Block(ch, heads, ctx_dim) for _ in range(layers)])
        self.proj_out = Linear(ch, ch) if linear else Conv2d(ch, ch, 1)

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        y = group_norm(self.norm, x)
        if not self.linear:
            y = self.proj_in(y)
        t = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
        if self.linear:
            t = self.proj_in(t)
        for blk in self.transformer_blocks:
            t = blk(t, ctx)
        if self.linear:
            t = self.proj_out(t)
        y = t.reshape(b, h, w, c).permute(0, 3, 1, 2)
        if not self.linear:
            y = self.proj_out(y)
        return y + x


class Sampler(_Mod):
    def __init__(self, ch, stride):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=stride, padding=1)


class UNet(_Mod):
    """forward(z [B, H, W, 4] NHWC, t [B], ctx [B, 77, D], pooled, time_ids)
    -> eps [B, H, W, 4]."""

    def __init__(self, c):
        super().__init__()
        c = self.c = ns(c)
        b0 = c.block_out_channels[0]
        temb = 4 * b0
        self.conv_in = Conv2d(c.in_channels, b0, 3, padding=1)
        self.time_embedding = MLP2(b0, temb)
        if c.addition_embed_type == "text_time":
            self.add_embedding = MLP2(c.projection_class_embeddings_input_dim,
                                      temb)

        def resnet(i, o):
            return Resnet(i, o, temb, c.norm_num_groups, c.norm_eps)

        def transformer(ch, level):
            return Transformer(ch, c.num_attention_heads[level],
                               c.transformer_layers_per_block[level],
                               c.cross_attention_dim, c.norm_num_groups,
                               c.use_linear_projection)

        n = len(c.block_out_channels)
        ch, skips = b0, [b0]
        self.down_blocks = nn.ModuleList()
        for i, (kind, out) in enumerate(zip(c.down_block_types,
                                            c.block_out_channels)):
            blk = _Mod()
            blk.resnets = nn.ModuleList()
            attn = kind == "CrossAttnDownBlock2D"
            if attn:
                blk.attentions = nn.ModuleList()
            for _ in range(c.layers_per_block):
                blk.resnets.append(resnet(ch, out))
                ch = out
                if attn:
                    blk.attentions.append(transformer(out, i))
                skips.append(ch)
            if i < n - 1:
                blk.downsamplers = nn.ModuleList([Sampler(ch, 2)])
                skips.append(ch)
            self.down_blocks.append(blk)
        self.mid_block = _Mod()
        self.mid_block.resnets = nn.ModuleList([resnet(ch, ch),
                                                resnet(ch, ch)])
        self.mid_block.attentions = nn.ModuleList([transformer(ch, n - 1)])
        rev = list(reversed(c.block_out_channels))
        self.up_blocks = nn.ModuleList()
        for i, kind in enumerate(c.up_block_types):
            blk = _Mod()
            blk.resnets = nn.ModuleList()
            attn = kind == "CrossAttnUpBlock2D"
            if attn:
                blk.attentions = nn.ModuleList()
            for _ in range(c.layers_per_block + 1):
                blk.resnets.append(resnet(ch + skips.pop(), rev[i]))
                ch = rev[i]
                if attn:
                    blk.attentions.append(transformer(ch, n - 1 - i))
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Sampler(ch, 1)])
            self.up_blocks.append(blk)
        self.conv_norm_out = nn.GroupNorm(c.norm_num_groups, ch,
                                          eps=c.norm_eps)
        self.conv_out = Conv2d(ch, c.out_channels, 3, padding=1)

    def forward(self, z, t, ctx, pooled=None, time_ids=None):
        c = self.c
        b = z.shape[0]
        t = torch.as_tensor(t, device=z.device).reshape(-1).expand(b)
        emb = self.time_embedding(timestep_embedding(
            t, c.block_out_channels[0], c.flip_sin_to_cos, c.freq_shift))
        if c.addition_embed_type == "text_time":
            ids = timestep_embedding(time_ids.reshape(-1),
                                     c.addition_time_embed_dim,
                                     c.flip_sin_to_cos, c.freq_shift)
            emb = emb + self.add_embedding(
                torch.cat([pooled, ids.reshape(b, -1)], dim=-1))
        x = self.conv_in(z.permute(0, 3, 1, 2))
        skips = [x]
        for blk in self.down_blocks:
            attns = getattr(blk, "attentions", None)
            for j, r in enumerate(blk.resnets):
                x = r(x, emb)
                if attns is not None:
                    x = attns[j](x, ctx)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0].conv(x)
                skips.append(x)
        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x, emb), ctx), emb)
        for blk in self.up_blocks:
            attns = getattr(blk, "attentions", None)
            for j, r in enumerate(blk.resnets):
                x = r(torch.cat([x, skips.pop()], dim=1), emb)
                if attns is not None:
                    x = attns[j](x, ctx)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(
                    F.interpolate(x, scale_factor=2.0, mode="nearest"))
        x = self.conv_out(F.silu(group_norm(self.conv_norm_out, x)))
        return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------- VAE
class VAEAttn(_Mod):
    def __init__(self, ch, groups):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q, self.to_k, self.to_v = (Linear(ch, ch) for _ in range(3))
        self.to_out = nn.ModuleList([Linear(ch, ch)])

    def forward(self, x):
        b, c, h, w = x.shape
        t = group_norm(self.group_norm, x).permute(0, 2, 3, 1).reshape(
            b, h * w, c)
        out = self.to_out[0](attention(self.ops, self.to_q(t), self.to_k(t),
                                       self.to_v(t), 1))
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class VAEDecoder(_Mod):
    """``decoder.*`` and ``post_quant_conv`` of `AutoencoderKL`:
    forward(z [B, h, w, 4], already divided by the scaling factor) ->
    images [B, H, W, 3] in [-1, 1] (unclamped)."""

    def __init__(self, c):
        super().__init__()
        c = ns(c)
        g, lat = c.norm_num_groups, c.latent_channels
        rev = list(reversed(c.block_out_channels))
        d = self.decoder = _Mod()
        ch = rev[0]
        d.conv_in = Conv2d(lat, ch, 3, padding=1)
        d.mid_block = _Mod()
        d.mid_block.resnets = nn.ModuleList(
            [Resnet(ch, ch, 0, g, 1e-6) for _ in range(2)])
        d.mid_block.attentions = nn.ModuleList([VAEAttn(ch, g)])
        d.up_blocks = nn.ModuleList()
        for i, out in enumerate(rev):
            blk = _Mod()
            blk.resnets = nn.ModuleList()
            for _ in range(c.layers_per_block + 1):
                blk.resnets.append(Resnet(ch, out, 0, g, 1e-6))
                ch = out
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([Sampler(ch, 1)])
            d.up_blocks.append(blk)
        d.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        d.conv_out = Conv2d(ch, c.out_channels, 3, padding=1)
        self.post_quant_conv = Conv2d(lat, lat, 1)

    def forward(self, z):
        d = self.decoder
        x = d.conv_in(self.post_quant_conv(z.permute(0, 3, 1, 2)))
        m = d.mid_block
        x = m.resnets[1](m.attentions[0](m.resnets[0](x)))
        for blk in d.up_blocks:
            for r in blk.resnets:
                x = r(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(
                    F.interpolate(x, scale_factor=2.0, mode="nearest"))
        x = d.conv_out(F.silu(group_norm(d.conv_norm_out, x)))
        return x.permute(0, 2, 3, 1)


def build(kind: str, cfg: dict, device, ops: Optional[Ops] = None):
    """An uninitialised float32 reference module on ``device`` (the weight
    generator fills it): ``kind`` is "unet", "vae", "text_encoder" or
    "text_encoder_2"."""
    make = {"unet": UNet, "vae": VAEDecoder, "text_encoder": CLIPText,
            "text_encoder_2": CLIPText}[kind]
    with torch.device("meta"):
        m = make(cfg)
    m = m.to_empty(device=device).eval().requires_grad_(False)
    return set_ops(m, ops or F32)
