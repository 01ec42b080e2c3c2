"""AutoencoderKL (SD VAE), counterpart of ``cfgpp_tpu/models/vae.py``.

Module names follow the diffusers state-dict layout, so a whole VAE state
dict loads strictly.  Parameters stay f32; ``compute_dtype`` is the dtype of
`decode` (bf16 on the card, as the JAX bundle decodes: f32 parameters, bf16
compute, f32 GroupNorm statistics).  `encode` computes in f32.  Images and
latents are NHWC at the public functions.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cfgpp_tpu_torch.configs import VAEConfig
from cfgpp_tpu_torch.models.attention import Conv2d, GroupNorm, Linear, sdpa


class VAEResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, eps=1e-6)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm(groups, out_ch, eps=1e-6)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttentionBlock(nn.Module):
    """Single-head self-attention over H*W tokens (diffusers mid-block attn);
    on the card it runs the flash kernel at d = channels = 512."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch, eps=1e-6)
        self.to_q = Linear(ch, ch)
        self.to_k = Linear(ch, ch)
        self.to_v = Linear(ch, ch)
        self.to_out = nn.ModuleList([Linear(ch, ch)])

    def forward(self, x):
        b, c, h, w = x.shape
        t = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, 1, c)
        out = sdpa(self.to_q(t), self.to_k(t), self.to_v(t)).reshape(b, h * w, c)
        out = self.to_out[0](out)
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class _MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(ch, ch, groups),
                                      VAEResnetBlock(ch, ch, groups)])
        self.attentions = nn.ModuleList([VAEAttentionBlock(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Block(nn.Module):
    """Holder giving diffusers' down_blocks.N / up_blocks.N names."""


class _Sampler(nn.Module):
    """Holder giving diffusers' downsamplers.0.conv / upsamplers.0.conv names."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        ch = cfg.block_out_channels[0]
        self.conv_in = Conv2d(cfg.in_channels, ch, 3, padding=1)
        self.down_blocks = nn.ModuleList()
        for i, out_ch in enumerate(cfg.block_out_channels):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(VAEResnetBlock(ch, out_ch, g))
                ch = out_ch
            if i < len(cfg.block_out_channels) - 1:
                blk.downsamplers = nn.ModuleList(
                    [_Sampler(Conv2d(ch, ch, 3, stride=2, padding=0))])
            self.down_blocks.append(blk)
        self.mid_block = _MidBlock(ch, g)
        self.conv_norm_out = GroupNorm(g, ch, eps=1e-6)
        self.conv_out = Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for r in blk.resnets:
                x = r(x)
            if hasattr(blk, "downsamplers"):
                # diffusers' VAE downsample pads asymmetrically (0, 1)
                x = blk.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        rev = list(reversed(cfg.block_out_channels))
        ch = rev[0]
        self.conv_in = Conv2d(cfg.latent_channels, ch, 3, padding=1)
        self.mid_block = _MidBlock(ch, g)
        self.up_blocks = nn.ModuleList()
        for i, out_ch in enumerate(rev):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(VAEResnetBlock(ch, out_ch, g))
                ch = out_ch
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList(
                    [_Sampler(Conv2d(ch, ch, 3, padding=1))])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(g, ch, eps=1e-6)
        self.conv_out = Conv2d(ch, cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            for r in blk.resnets:
                x = r(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(
                    F.interpolate(x, scale_factor=2.0, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """encode image -> (mean, logvar); decode latent -> image.  Both NHWC."""

    def __init__(self, cfg: VAEConfig,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = cfg
        self.compute_dtype = compute_dtype
        self.encoder = VAEEncoder(cfg)
        self.decoder = VAEDecoder(cfg)
        # SD3's VAE has neither 1x1 conv (``use_quant_conv`` and
        # ``use_post_quant_conv`` false in `configs_sd3.SD3VAEConfig`)
        self.quant_conv = (Conv2d(2 * cfg.latent_channels,
                                  2 * cfg.latent_channels, 1)
                           if getattr(cfg, "use_quant_conv", True) else None)
        self.post_quant_conv = (Conv2d(cfg.latent_channels,
                                       cfg.latent_channels, 1)
                                if getattr(cfg, "use_post_quant_conv", True)
                                else None)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        moments = self.encoder(x.permute(0, 3, 1, 2).float())
        if self.quant_conv is not None:
            moments = self.quant_conv(moments)
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        x = z.permute(0, 3, 1, 2).to(self.compute_dtype)
        if self.post_quant_conv is not None:
            x = self.post_quant_conv(x)
        return self.decoder(x).permute(0, 2, 3, 1)
