"""FLOPs of a unit of the SD / SDXL UNet family, from its configuration
file alone.

A copy of ``cfgpp_tpu_torch/utils/flops.py`` (itself a copy of the JAX
package's) over the benchmark's JSON configurations, corrected where a count
of the modules with ``torch.utils.flop_counter.FlopCounterMode`` disagreed
(``tests/test_bench_port_flops.py``):

* the engine computes the cross-attention k/v once per request
  (``precompute_cross_kv``), so `unet_call_flops` leaves them out unless
  ``cross_kv=True`` and `unit_flops` counts them once per unit;
* the time embedding MLP and SDXL's added-embedding MLP are counted;
* `clip_flops` counts the text encoders, which the copy left out.

Multiply-accumulates count two; norms, activations and softmax are not
counted.  Attention's two products count 2 x 2 B H N M D.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Tuple

TOKENS = 77


def _ns(d) -> SimpleNamespace:
    return d if isinstance(d, SimpleNamespace) else SimpleNamespace(**d)


def unet_call_flops(cfg, batch: int, latent_hw: int,
                    cross_kv: bool = False) -> Dict[str, float]:
    """One UNet forward of ``batch`` rows at latent_hw^2: {"conv", "matmul",
    "attn", "total"}."""
    cfg = _ns(cfg)
    acc = {"conv": 0.0, "matmul": 0.0, "attn": 0.0}

    def conv(b, h, w, cin, cout, k=3):
        acc["conv"] += 2.0 * b * h * w * cin * cout * k * k

    def mm(rows, cin, cout):
        acc["matmul"] += 2.0 * rows * cin * cout

    def attn(b, heads, n, m, d):
        acc["attn"] += 2.0 * b * heads * n * m * d * 2

    ch = cfg.block_out_channels
    layers = cfg.transformer_layers_per_block
    heads = cfg.num_attention_heads
    ctx = cfg.cross_attention_dim
    lpb = cfg.layers_per_block
    temb = 4 * ch[0]
    B = batch

    def transformer(b, n, c, nheads, nlayers):
        d = c // nheads
        mm(b * n, c, c)
        mm(b * n, c, c)              # proj_in / proj_out
        for _ in range(nlayers):
            mm(b * n, c, 3 * c)      # self q, k, v
            attn(b, nheads, n, n, d)
            mm(b * n, c, c)          # self out
            mm(b * n, c, c)          # cross q
            if cross_kv:
                mm(b * TOKENS, ctx, 2 * c)
            attn(b, nheads, n, TOKENS, d)
            mm(b * n, c, c)          # cross out
            mm(b * n, c, 8 * c)      # GEGLU proj
            mm(b * n, 4 * c, c)      # ff out

    def resnet(b, h, w, cin, cout):
        conv(b, h, w, cin, cout)
        conv(b, h, w, cout, cout)
        if cin != cout:
            conv(b, h, w, cin, cout, k=1)
        mm(b, temb, cout)

    mm(B, ch[0], temb)               # time embedding MLP
    mm(B, temb, temb)
    if cfg.addition_embed_type == "text_time":
        mm(B, cfg.projection_class_embeddings_input_dim, temb)
        mm(B, temb, temb)
    hw = latent_hw
    conv(B, hw, hw, cfg.in_channels, ch[0])
    skips = [(ch[0], hw)]
    x_ch = ch[0]
    for i, c in enumerate(ch):
        has_attn = cfg.down_block_types[i] == "CrossAttnDownBlock2D"
        for _ in range(lpb):
            resnet(B, hw, hw, x_ch, c)
            x_ch = c
            if has_attn:
                transformer(B, hw * hw, c, heads[i], layers[i])
            skips.append((c, hw))
        if i < len(ch) - 1:
            hw //= 2
            conv(B, hw, hw, c, c)
            skips.append((c, hw))
    resnet(B, hw, hw, ch[-1], ch[-1])
    transformer(B, hw * hw, ch[-1], heads[-1], layers[-1])
    resnet(B, hw, hw, ch[-1], ch[-1])
    rev = list(reversed(ch))
    rh = list(reversed(heads))
    rl = list(reversed(layers))
    for i, block_type in enumerate(cfg.up_block_types):
        has_attn = block_type == "CrossAttnUpBlock2D"
        for _ in range(lpb + 1):
            sc, _shw = skips.pop()
            resnet(B, hw, hw, x_ch + sc, rev[i])
            x_ch = rev[i]
            if has_attn:
                transformer(B, hw * hw, rev[i], rh[i], rl[i])
        if i < len(ch) - 1:
            hw *= 2
            conv(B, hw, hw, rev[i], rev[i])
    conv(B, latent_hw, latent_hw, ch[0], cfg.out_channels)
    acc["total"] = acc["conv"] + acc["matmul"] + acc["attn"]
    return acc


def cross_kv_flops(cfg, batch: int) -> float:
    """The cross-attention k and v of every transformer layer, once."""
    cfg = _ns(cfg)
    return sum(count * 2.0 * batch * TOKENS * cfg.cross_attention_dim * 2
               * cfg.block_out_channels[level]
               for level, count in layers_by_level(cfg).items())


def layers_by_level(cfg) -> Dict[int, int]:
    """{level: transformer layers at that level} over the down blocks, the
    mid block and the up blocks."""
    cfg = _ns(cfg)
    n = len(cfg.block_out_channels)
    out: Dict[int, int] = {}
    for i, t in enumerate(cfg.down_block_types):
        if t == "CrossAttnDownBlock2D":
            out[i] = out.get(i, 0) + cfg.layers_per_block * \
                cfg.transformer_layers_per_block[i]
    out[n - 1] = out.get(n - 1, 0) + cfg.transformer_layers_per_block[-1]
    for i, t in enumerate(cfg.up_block_types):
        if t == "CrossAttnUpBlock2D":
            level = n - 1 - i
            out[level] = out.get(level, 0) + (cfg.layers_per_block + 1) * \
                cfg.transformer_layers_per_block[level]
    return out


def vae_decode_flops(cfg, latent_hw: int, batch: int = 1) -> float:
    """One VAE decode of [batch, latent_hw, latent_hw, C]."""
    cfg = _ns(cfg)
    total = 0.0

    def conv(h, w, cin, cout, k=3):
        nonlocal total
        total += 2.0 * batch * h * w * cin * cout * k * k

    rev = list(reversed(cfg.block_out_channels))
    hw = latent_hw
    conv(hw, hw, cfg.latent_channels, cfg.latent_channels, k=1)  # post_quant
    conv(hw, hw, cfg.latent_channels, rev[0])
    for _ in range(2):
        conv(hw, hw, rev[0], rev[0])
        conv(hw, hw, rev[0], rev[0])
    n = hw * hw
    total += 2.0 * batch * n * rev[0] * rev[0] * 4      # q/k/v/out projections
    total += 2.0 * batch * n * n * rev[0] * 2           # QK^T + PV
    x_ch = rev[0]
    for i, c in enumerate(rev):
        for _ in range(cfg.layers_per_block + 1):
            conv(hw, hw, x_ch, c)
            conv(hw, hw, c, c)
            if x_ch != c:
                conv(hw, hw, x_ch, c, k=1)
            x_ch = c
        if i < len(rev) - 1:
            hw *= 2
            conv(hw, hw, c, c)
    conv(hw, hw, x_ch, cfg.out_channels)
    return total


def clip_flops(cfg, rows: int) -> float:
    """One text encoder over ``rows`` prompts of 77 tokens, with the
    projection of the pooled output where there is one."""
    cfg = _ns(cfg)
    t, h = rows * TOKENS, cfg.hidden_size
    per_layer = 2.0 * t * h * h * 4 + 2.0 * t * h * cfg.intermediate_size * 2
    per_layer += 2.0 * 2 * rows * TOKENS * TOKENS * h
    proj = 2.0 * rows * h * cfg.projection_dim if cfg.projection_dim else 0.0
    return per_layer * cfg.num_layers + proj


def latent_hw(config: Dict, mix: Dict) -> int:
    return mix["resolution"] // 2 ** (len(config["vae"]["block_out_channels"])
                                      - 1)


def unet_calls(mix: Dict) -> int:
    """UNet calls of one unit (DPM++ 2M loops over timesteps[:-1])."""
    return mix["nfe"] - 1 if mix["solver"].startswith("dpm++_2m") \
        else mix["nfe"]


def unit_flops(config: Dict, mix: Dict) -> float:
    """One unit of the mix: text encode of the null and the conditional
    prompts, the cross k/v once, every UNet call on both branches, and one
    decode per image."""
    images = mix["batch"]
    rows = 2 * images
    hw = latent_hw(config, mix)
    total = clip_flops(config["text_encoder"], rows)
    if "text_encoder_2" in config:
        total += clip_flops(config["text_encoder_2"], rows)
    total += cross_kv_flops(config["unet"], rows)
    total += unet_calls(mix) * unet_call_flops(config["unet"], rows,
                                               hw)["total"]
    return total + images * vae_decode_flops(config["vae"], hw)


def attention_sites(config: Dict, mix: Dict) -> List[Tuple[int, int, int, int, int, int]]:
    """(batch, nq, kv_len, heads, head_dim, calls per unit) of every
    attention of one unit: each transformer layer's self- and
    cross-attention in every UNet call, and the VAE mid-block's."""
    u = _ns(config["unet"])
    rows = 2 * mix["batch"]
    hw = latent_hw(config, mix)
    calls = unet_calls(mix)
    sites = []
    for level, count in layers_by_level(u).items():
        c = u.block_out_channels[level]
        heads = u.num_attention_heads[level]
        n = (hw >> level) ** 2
        sites.append((rows, n, n, heads, c // heads, count * calls))
        sites.append((rows, n, TOKENS, heads, c // heads, count * calls))
    c = config["vae"]["block_out_channels"][-1]
    sites.append((1, hw * hw, hw * hw, 1, c, mix["batch"]))
    return sites
