"""The plain float32 reference of the SD3 family: the MMDiT and T5's encoder
written here from the published equations (diffusers'
`SD3Transformer2DModel` / `JointTransformerBlock`, transformers'
`T5EncoderModel`), with their state-dict names, over the CLIP text tower
of ``bench_port/reference/models.py`` and its VAE decoder without the
post-quant conv; its own tokenizers, flow schedule and CFG / CFG++ loops.
Every matrix product and convolution goes through the modules' `Ops`
(``reference/ops.py``), so the control can lower it.  It imports nothing of
the port.

Departures from diffusers and transformers, each on purpose:

* the MMDiT's joint attention is computed `HEAD_BLOCK` heads at a time
  (the scores of all 38 heads at batch 2 over 4429 tokens would take 6 GB
  in float32 beside 55 GB of weights), so the control's fp8 rounds the
  scores' operands with one scale per block of heads, not per tensor;
* the position table is computed for the cropped grid alone, in float64,
  instead of cropped from a stored 192 x 192 table (the same numbers);
* latents are NHWC at the public functions, as the program's are;
* T5 runs over the padded tokens without a mask, as SD3's pipeline runs
  it; its tokenizer is a hash of each lower-cased word into the
  SentencePiece ids [3, vocab - 128), then EOS (1), padded with 0.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bench_port.reference import models
from bench_port.reference.models import Conv2d, Linear, MLP2, _Mod, set_ops
from bench_port.reference.ops import F32, Ops
from bench_port.reference.pipeline import initial_latent, tokenize

EPS = 1e-6
HEAD_BLOCK = 8


def t5_tokenize(texts: List[str], vocab: int, length: int) -> np.ndarray:
    out = np.zeros((len(texts), length), np.int64)
    for i, text in enumerate(texts):
        ids = [3 + int(hashlib.md5(w.encode()).hexdigest(), 16) % (vocab - 131)
               for w in text.lower().split()][:length - 1]
        out[i, :len(ids) + 1] = ids + [1]
    return out


def flow_sigmas(nfe: int, shift: float, train_steps: int) -> List[float]:
    """nfe + 1 noise levels: t = linspace(N, N s(1/N), nfe), sigma = s(t /
    N), then 0; s(u) = shift u / (1 + (shift - 1) u)."""
    def s(u):
        return shift * u / (1 + (shift - 1) * u)
    t = np.linspace(train_steps, train_steps * s(1 / train_steps), nfe)
    return [float(s(x / train_steps)) for x in t] + [0.0]


def rms(x, weight):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + EPS) * weight


def ln(x):
    return F.layer_norm(x, (x.shape[-1],), eps=EPS)


def attention_blocks(ops: Ops, q, k, v, heads: int, bias=None, scale=None):
    """q, k, v [B, N, H*D] -> [B, N, H*D]; `HEAD_BLOCK` heads at a time;
    ``bias`` [1, H, N, N] added to the scores; ``scale`` D^-1/2 unless
    given."""
    b, n, hd = q.shape
    d = hd // heads
    scale = d ** -0.5 if scale is None else scale
    qh, kh, vh = (t.reshape(b, n, heads, d).transpose(1, 2) for t in (q, k, v))
    out = torch.empty_like(qh)
    for h0 in range(0, heads, HEAD_BLOCK):
        h1 = min(heads, h0 + HEAD_BLOCK)
        s = ops.matmul(qh[:, h0:h1], kh[:, h0:h1].transpose(-1, -2)) * scale
        if bias is not None:
            s = s + bias[:, h0:h1]
        out[:, h0:h1] = ops.matmul(torch.softmax(s, dim=-1), vh[:, h0:h1])
        del s
    return out.transpose(1, 2).reshape(b, n, hd)


# -------------------------------------------------------------------- MMDiT
class HeadNorm(nn.Module):
    """Per-head RMSNorm with a weight (its name ends in Norm: the fill sets
    a scale-only norm's weight to 1)."""

    def __init__(self, d):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))

    def forward(self, x, heads):
        b, n, hd = x.shape
        return rms(x.reshape(b, n, heads, hd // heads), self.weight).reshape(
            b, n, hd)


class Modulation(_Mod):
    """``linear`` of silu(temb), chunked in ``n``."""

    def __init__(self, d, n):
        super().__init__()
        self.n = n
        self.linear = Linear(d, n * d)

    def forward(self, temb):
        return self.linear(F.silu(temb))[:, None].chunk(self.n, dim=-1)


class FF(_Mod):
    def __init__(self, d):
        super().__init__()
        act = _Mod()
        act.proj = Linear(d, 4 * d)
        self.net = nn.ModuleList([act, nn.Identity(), Linear(4 * d, d)])

    def forward(self, x):
        return self.net[2](F.gelu(self.net[0].proj(x), approximate="tanh"))


class JointBlock(_Mod):
    def __init__(self, d, heads, head_dim, last):
        super().__init__()
        self.heads, self.last = heads, last
        self.norm1 = Modulation(d, 6)
        self.norm1_context = Modulation(d, 2 if last else 6)
        a = self.attn = _Mod()
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                     "add_v_proj"):
            setattr(a, name, Linear(d, d))
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            setattr(a, name, HeadNorm(head_dim))
        a.to_out = nn.ModuleList([Linear(d, d)])
        if not last:
            a.to_add_out = Linear(d, d)
            self.ff_context = FF(d)
        self.ff = FF(d)

    def forward(self, x, c, temb):
        a, h = self.attn, self.heads
        sh, sc, g, sh2, sc2, g2 = self.norm1(temb)
        nx = ln(x) * (1 + sc) + sh
        if self.last:
            c_sc, c_sh = self.norm1_context(temb)
            nc = ln(c) * (1 + c_sc) + c_sh
        else:
            c_sh, c_sc, c_g, c_sh2, c_sc2, c_g2 = self.norm1_context(temb)
            nc = ln(c) * (1 + c_sc) + c_sh
        q = torch.cat([a.norm_q(a.to_q(nx), h),
                       a.norm_added_q(a.add_q_proj(nc), h)], dim=1)
        k = torch.cat([a.norm_k(a.to_k(nx), h),
                       a.norm_added_k(a.add_k_proj(nc), h)], dim=1)
        v = torch.cat([a.to_v(nx), a.add_v_proj(nc)], dim=1)
        out = attention_blocks(self.ops, q, k, v, h)
        n = x.shape[1]
        x = x + g * a.to_out[0](out[:, :n])
        x = x + g2 * self.ff(ln(x) * (1 + sc2) + sh2)
        if self.last:
            return x, None
        c = c + c_g * a.to_add_out(out[:, n:])
        return x, c + c_g2 * self.ff_context(ln(c) * (1 + c_sc2) + c_sh2)


def position_table(d: int, max_size: int, base: int, h: int, w: int
                   ) -> torch.Tensor:
    """[h * w, d] float64: the sin-cos table of the centre h x w of a
    max_size grid at positions p / (max_size / base); column then row."""
    top, left = (max_size - h) // 2, (max_size - w) // 2
    step = max_size / base
    omega = 10000.0 ** (-torch.arange(d // 4, dtype=torch.float64) / (d / 4))

    def half(p):
        a = p[:, None] * omega[None]
        return torch.cat([torch.sin(a), torch.cos(a)], dim=1)
    rows = (top + torch.arange(h, dtype=torch.float64)) / step
    cols = (left + torch.arange(w, dtype=torch.float64)) / step
    r, c = torch.meshgrid(rows, cols, indexing="ij")
    return torch.cat([half(c.reshape(-1)), half(r.reshape(-1))], dim=1)


class MMDiT(_Mod):
    """forward(x [B, h, w, C] NHWC, t [1] or [B] (1000 sigma), ctx [B, M,
    joint dim], pooled [B, pooled dim]) -> the velocity [B, h, w, C]."""

    def __init__(self, c: Dict):
        super().__init__()
        self.c = c
        d = c["num_attention_heads"] * c["attention_head_dim"]
        p = c["patch_size"]
        self.d = d
        self.pos_embed = _Mod()
        self.pos_embed.proj = Conv2d(c["in_channels"], d, p, stride=p)
        self.time_text_embed = _Mod()
        self.time_text_embed.timestep_embedder = MLP2(256, d)
        self.time_text_embed.text_embedder = MLP2(c["pooled_projection_dim"],
                                                  d)
        self.context_embedder = Linear(c["joint_attention_dim"], d)
        n = c["num_layers"]
        self.transformer_blocks = nn.ModuleList([
            JointBlock(d, c["num_attention_heads"], c["attention_head_dim"],
                       i == n - 1) for i in range(n)])
        self.norm_out = Modulation(d, 2)
        self.proj_out = Linear(d, p * p * c["out_channels"])

    def forward(self, x, t, ctx, pooled):
        c = self.c
        b, h, w, _ = x.shape
        p = c["patch_size"]
        t = torch.as_tensor(t, device=x.device).reshape(-1).expand(b)
        tt = self.time_text_embed
        temb = tt.timestep_embedder(models.timestep_embedding(t, 256, True, 0)
                                    ) + tt.text_embedder(pooled)
        tokens = self.pos_embed.proj(x.permute(0, 3, 1, 2))
        tokens = tokens.flatten(2).transpose(1, 2) + position_table(
            self.d, c["pos_embed_max_size"], c["sample_size"] // p, h // p,
            w // p).to(x.device, torch.float32)[None]
        cx = self.context_embedder(ctx)
        for blk in self.transformer_blocks:
            tokens, cx = blk(tokens, cx, temb)
        scale, shift = self.norm_out(temb)
        out = self.proj_out(ln(tokens) * (1 + scale) + shift)
        out = out.reshape(b, h // p, w // p, p, p, c["out_channels"])
        return out.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


# ----------------------------------------------------------------------- T5
def t5_buckets(rel: torch.Tensor, buckets: int, max_distance: int):
    """Bidirectional relative-position buckets of key - query distances."""
    half = buckets // 2
    out = (rel > 0).long() * half
    dist = rel.abs()
    exact = half // 2
    far = exact + (torch.log(dist.float().clamp(min=1) / exact)
                   / math.log(max_distance / exact) * (half - exact)).long()
    far = far.clamp(max=half - 1)
    return out + torch.where(dist < exact, dist, far)


class T5Norm(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))


class T5(_Mod):
    """forward(ids [B, T]) -> the last hidden state after the final norm."""

    def __init__(self, c: Dict):
        super().__init__()
        self.c = c
        d, inner = c["d_model"], c["num_heads"] * c["d_kv"]
        self.shared = nn.Embedding(c["vocab_size"], d)
        self.encoder = _Mod()
        self.encoder.block = nn.ModuleList()
        for i in range(c["num_layers"]):
            attn, ff = _Mod(), _Mod()
            attn.SelfAttention = _Mod()
            sa = attn.SelfAttention
            sa.q, sa.k, sa.v = (Linear(d, inner, bias=False)
                                for _ in range(3))
            sa.o = Linear(inner, d, bias=False)
            if i == 0:
                sa.relative_attention_bias = nn.Embedding(
                    c["relative_attention_num_buckets"], c["num_heads"])
            attn.layer_norm = T5Norm(d)
            ff.DenseReluDense = _Mod()
            dr = ff.DenseReluDense
            dr.wi_0 = Linear(d, c["d_ff"], bias=False)
            dr.wi_1 = Linear(d, c["d_ff"], bias=False)
            dr.wo = Linear(c["d_ff"], d, bias=False)
            ff.layer_norm = T5Norm(d)
            blk = _Mod()
            blk.layer = nn.ModuleList([attn, ff])
            self.encoder.block.append(blk)
        self.encoder.final_layer_norm = T5Norm(d)

    def forward(self, ids):
        c, eps = self.c, self.c["layer_norm_epsilon"]

        def norm(x, m):
            return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
                * m.weight
        x = self.shared(ids)
        n = ids.shape[1]
        pos = torch.arange(n, device=ids.device)
        buckets = t5_buckets(pos[None, :] - pos[:, None],
                             c["relative_attention_num_buckets"],
                             c["relative_attention_max_distance"])
        sa0 = self.encoder.block[0].layer[0].SelfAttention
        bias = sa0.relative_attention_bias(buckets).permute(2, 0, 1)[None]
        for blk in self.encoder.block:
            attn, ff = blk.layer
            sa, y = attn.SelfAttention, norm(x, attn.layer_norm)
            x = x + sa.o(attention_blocks(self.ops, sa.q(y), sa.k(y), sa.v(y),
                                          c["num_heads"], bias, 1.0))
            dr, y = ff.DenseReluDense, norm(x, ff.layer_norm)
            x = x + dr.wo(F.gelu(dr.wi_0(y), approximate="tanh") * dr.wi_1(y))
        return norm(x, self.encoder.final_layer_norm)


# ---------------------------------------------------------------------- VAE
class VAEDecoder16(models.VAEDecoder):
    """The decoder of `models.VAEDecoder` without ``post_quant_conv``."""

    def __init__(self, c):
        super().__init__(c)
        del self.post_quant_conv

    def forward(self, z):
        d = self.decoder
        x = d.conv_in(z.permute(0, 3, 1, 2))
        m = d.mid_block
        x = m.resnets[1](m.attentions[0](m.resnets[0](x)))
        for blk in d.up_blocks:
            for r in blk.resnets:
                x = r(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(
                    F.interpolate(x, scale_factor=2.0, mode="nearest"))
        x = d.conv_out(F.silu(models.group_norm(d.conv_norm_out, x)))
        return x.permute(0, 2, 3, 1)


# ----------------------------------------------------------------- pipeline
def _built(module: nn.Module, device, ops) -> nn.Module:
    return set_ops(module.to_empty(device=device).eval().requires_grad_(False),
                   ops or F32)


class Reference:
    """The reference models of one configuration (filled by the caller,
    ``check.reference``)."""

    def __init__(self, config: Dict, device, ops: Optional[Ops] = None):
        self.config, self.device = config, torch.device(device)
        with torch.device("meta"):
            made = {"transformer": MMDiT(config["transformer"]),
                    "text_encoder_3": T5(config["text_encoder_3"]),
                    "vae": VAEDecoder16(config["vae"])}
        self.mods = {name: _built(m, device, ops) for name, m in made.items()}
        for part in ("text_encoder", "text_encoder_2"):
            self.mods[part] = models.build(part, config[part], device, ops)

    def modules(self) -> Dict[str, nn.Module]:
        return dict(self.mods)

    def embed(self, texts: List[str]):
        """(context [B, 77 + T, d_t5], pooled [B, 2048]) of the prompts."""
        cfg, m = self.config, self.mods

        def ids(part, pad):
            c = cfg[part]
            return torch.as_tensor(tokenize(texts, c["vocab_size"],
                                            c["eos_token_id"], pad),
                                   device=self.device)
        _, pen1, pool1 = m["text_encoder"](ids("text_encoder", None))
        _, pen2, pool2 = m["text_encoder_2"](ids("text_encoder_2", 0))
        t5_ids = torch.as_tensor(t5_tokenize(
            texts, cfg["text_encoder_3"]["vocab_size"],
            cfg["max_sequence_length"]), device=self.device)
        t5 = m["text_encoder_3"](t5_ids)
        clip = torch.cat([pen1, pen2], dim=-1)
        clip = F.pad(clip, (0, t5.shape[-1] - clip.shape[-1]))
        return (torch.cat([clip, t5], dim=1),
                torch.cat([pool1, pool2], dim=-1))

    @torch.no_grad()
    def image(self, mix: Dict, null_prompt: str, prompt: str, seed: int,
              index: Optional[int] = None) -> torch.Tensor:
        """float32 [H, W, 3] in [0, 1] of one request (or one sample of a
        batch: ``index``)."""
        cfg, m = self.config, self.mods
        vae = cfg["vae"]
        hw = mix["resolution"] // 2 ** (len(vae["block_out_channels"]) - 1)
        ctx, pooled = self.embed([null_prompt, prompt])
        x = initial_latent((1, hw, hw, vae["latent_channels"]), seed, index,
                           1.0, self.device)
        w = float(mix["guidance"])
        cfgpp = mix["solver"] == "flow_euler_cfg++"
        if not cfgpp and mix["solver"] != "flow_euler":
            raise ValueError(f"the SD3 reference has no solver "
                             f"{mix['solver']!r}")
        sch = cfg["scheduler"]
        sig = flow_sigmas(mix["nfe"], sch["shift"],
                          sch["num_train_timesteps"])
        for s, s_next in zip(sig[:-1], sig[1:]):
            v = m["transformer"](torch.cat([x, x]), torch.tensor(
                [sch["num_train_timesteps"] * s], device=self.device), ctx,
                pooled)
            v_u, v_c = v[:1], v[1:]
            v_w = v_u + w * (v_c - v_u)
            if cfgpp:
                x0 = x - s * v_w
                x = (1 - s_next) * x0 + s_next * (x + (1 - s) * v_u)
            else:
                x = x + (s_next - s) * v_w
        img = m["vae"](x / vae["scaling_factor"] + vae["shift_factor"])
        return (img[0] / 2 + 0.5).clamp(0.0, 1.0)
