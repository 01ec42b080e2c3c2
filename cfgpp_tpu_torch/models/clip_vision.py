"""CLIP vision transformer (image tower) for CLIP-score and CLIP-FID,
counterpart of ``cfgpp_tpu/models/clip_vision.py``.

Module names follow the HF transformers ``CLIPVisionModelWithProjection``
state-dict layout (``vision_model.encoder.layers.N.self_attn.q_proj`` ...,
``vision_model.pre_layrnorm`` with its spelling), so an HF state dict loads
as it stands (`cfgpp_tpu_torch.weights.convert.clip_vision_from_hf`).  The
tower runs in f32, as the Flax module does (no dtype is set there); the
attention is the plain f32-softmax form (`sdpa_reference`, the counterpart
of ``sdpa_xla``), as the JAX tower's `CLIPAttention` calls it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cfgpp_tpu_torch.models.attention import (CLIPAttention, Conv2d,
                                              LayerNorm, Linear)
from cfgpp_tpu_torch.models.clip import quick_gelu


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024          # ViT-L/14
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 224
    patch_size: int = 14
    projection_dim: Optional[int] = 768
    layer_norm_eps: float = 1e-5


class _VisionMLP(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class _VisionLayer(nn.Module):
    """Pre-LN: x + attn(ln1(x)), then x + mlp(ln2(x)); no mask."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = _VisionMLP(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x), None)
        return x + self.mlp(self.layer_norm2(x))


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                      stride=cfg.patch_size, bias=False)
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [_VisionLayer(cfg) for _ in range(cfg.num_layers)])


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPVisionModel(nn.Module):
    """Images [B, H, W, 3] in CLIP-normalized space (NHWC, as the JAX
    module takes them) -> the class token's projected embedding [B,
    projection_dim] (or [B, hidden_size] without a projection)."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        self.vision_model = _VisionTransformer(cfg)
        self.visual_projection = (
            Linear(cfg.hidden_size, cfg.projection_dim, bias=False)
            if cfg.projection_dim is not None else None)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        vm = self.vision_model
        emb = vm.embeddings
        b = pixels.shape[0]
        patches = emb.patch_embedding(pixels.permute(0, 3, 1, 2))
        patches = patches.flatten(2).transpose(1, 2)     # [B, N, C], row-major
        cls = emb.class_embedding.to(patches.dtype).expand(b, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        x = x + emb.position_embedding.weight[None, :x.shape[1]].to(x.dtype)
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x)
        pooled = vm.post_layernorm(x[:, 0])
        if self.visual_projection is not None:
            pooled = self.visual_projection(pooled)
        return pooled


# CLIP preprocessing constants (OpenAI CLIP normalization).
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_for_clip(images01: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[B,H,W,3] in [0,1] -> resized + CLIP-normalized [B,size,size,3].

    Square inputs only: a batched squash-resize of non-square images would
    distort aspect ratio and silently diverge from the CLIP processor's
    shortest-side-resize + center-crop — crop on the host first
    (metrics/clip_score.py:load224 is the reference implementation).  A
    square of another size is resized as ``jax.image.resize(...,
    "bicubic")`` does it (the a = -0.5 cubic, antialiased when it shrinks);
    at ``size`` itself the images pass unchanged, as they do there.
    """
    b, h, w, _ = images01.shape
    if h != w:
        raise ValueError(
            f"preprocess_for_clip needs square images (got {h}x{w}); "
            "resize-shortest-side + center-crop on the host first "
            "(see metrics/clip_score.py:load224)")
    imgs = images01
    if h != size:
        imgs = F.interpolate(imgs.permute(0, 3, 1, 2), size=(size, size),
                             mode="bicubic", antialias=True,
                             align_corners=False).permute(0, 2, 3, 1)
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=imgs.dtype, device=imgs.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=imgs.dtype, device=imgs.device)
    return (imgs - mean) / std
