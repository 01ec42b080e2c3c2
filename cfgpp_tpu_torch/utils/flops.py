"""Exact FLOP accounting of a sampling run, from the model config alone.

A copy of ``cfgpp_tpu/utils/flops.py`` over the port's `configs` (the same
three functions, arguments and dict keys; ``tests/test_torch_port_copies.py``
holds the two equal on every preset).  Counts multiply-accumulates x2 for
every conv, matmul and attention contraction in the UNet denoising step and
the VAE decode.  A benchmark divides these counts by a measured time for an
achieved rate; the card's peak rates are in `cfgpp_tpu_torch.utils.roofline`.
"""

from __future__ import annotations

from cfgpp_tpu_torch.configs import ModelBundleConfig, UNetConfig, VAEConfig


def unet_step_flops(cfg: UNetConfig, batch: int, latent_hw: int) -> dict:
    """FLOPs of one UNet forward at [batch, latent_hw, latent_hw, in_ch].

    ``batch`` counts UNet rows (a CFG step runs batch=2*images).
    Returns {"conv": f, "matmul": f, "attn": f, "total": f}.
    """
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
    B = batch

    def transformer(b, n, c, nheads, nlayers):
        d = c // nheads
        mm(b * n, c, c)
        mm(b * n, c, c)              # proj_in / proj_out
        for _ in range(nlayers):
            mm(b * n, c, 3 * c)      # fused self qkv
            attn(b, nheads, n, n, d)
            mm(b * n, c, c)          # self out
            mm(b * n, c, c)          # cross q
            mm(b * 77, ctx, 2 * c)   # cross k+v
            attn(b, nheads, n, 77, d)
            mm(b * n, c, c)          # cross out
            mm(b * n, c, 8 * c)      # GEGLU proj
            mm(b * n, 4 * c, c)      # ff out

    def resnet(b, h, w, cin, cout):
        conv(b, h, w, cin, cout)
        conv(b, h, w, cout, cout)
        if cin != cout:
            conv(b, h, w, cin, cout, k=1)
        mm(b, cfg.time_embed_dim, cout)

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


def vae_decode_flops(cfg: VAEConfig, latent_hw: int, batch: int = 1) -> float:
    """FLOPs of one VAE decode from [batch, latent_hw, latent_hw, C]."""
    total = 0.0

    def conv(h, w, cin, cout, k=3):
        nonlocal total
        total += 2.0 * batch * h * w * cin * cout * k * k

    rev = list(reversed(cfg.block_out_channels))
    hw = latent_hw
    conv(hw, hw, cfg.latent_channels, cfg.latent_channels, k=1)  # post_quant
    conv(hw, hw, cfg.latent_channels, rev[0])
    # mid: 2 resnets + single-head attention over hw^2 tokens
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
    conv(hw, hw, x_ch, cfg.in_channels)
    return total


def pipeline_flops(bundle_cfg: ModelBundleConfig, resolution: int,
                   n_model_steps: int, images: int = 1,
                   dual_branch: bool = True) -> dict:
    """Total FLOPs for a sampling run (text encode excluded: <0.5%)."""
    latent_hw = resolution // bundle_cfg.vae.scale_factor
    rows = images * (2 if dual_branch else 1)
    step = unet_step_flops(bundle_cfg.unet, rows, latent_hw)
    vae = vae_decode_flops(bundle_cfg.vae, latent_hw, images)
    return {
        "unet_step": step,
        "unet_total": step["total"] * n_model_steps,
        "vae_decode": vae,
        "total": step["total"] * n_model_steps + vae,
    }
