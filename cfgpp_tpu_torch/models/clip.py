"""CLIP text encoder (ViT-L/14 for SD-1.5, OpenCLIP ViT-H/14's with erf
gelu for SD-2.x), counterpart of
``cfgpp_tpu/models/clip.py``.

Module names follow the HF transformers state-dict layout
(``text_model.encoder.layers.N.self_attn.q_proj`` ...).  The encoder runs in
f32, as the JAX bundle runs it (``cfgpp_tpu/engine/bundle.py:107``): two
77-token calls per request are a negligible share of the sampling cost.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cfgpp_tpu_torch.configs import CLIPTextConfig
from cfgpp_tpu_torch.models.attention import CLIPAttention, LayerNorm, Linear


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = quick_gelu if cfg.hidden_act == "quick_gelu" else F.gelu
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


@dataclasses.dataclass
class CLIPTextOutput:
    last_hidden_state: torch.Tensor          # after the final LN   [B, 77, H]
    penultimate_hidden_state: torch.Tensor   # layer N-1 output, no final LN
    pooled_output: torch.Tensor              # eos-pooled (projected if configured)


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    """Returns the last hidden state, the penultimate hidden state and the
    (optionally projected) pooled output."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.config = cfg
        self.text_model = _TextTransformer(cfg)
        self.text_projection = (
            Linear(cfg.hidden_size, cfg.projection_dim, bias=False)
            if cfg.projection_dim is not None else None)

    def forward(self, input_ids: torch.Tensor,
                clip_skip: Optional[int] = None) -> CLIPTextOutput:
        """``clip_skip``: None -> penultimate layer output (HF
        hidden_states[-2]); k -> hidden_states[-(k+2)]."""
        tm = self.text_model
        b, n = input_ids.shape
        pos = tm.embeddings.position_embedding.weight[:n]
        x = tm.embeddings.token_embedding(input_ids) + pos[None]
        mask = torch.full((n, n), float("-inf"), device=x.device).triu(1)
        mask = mask[None, None]
        hiddens = [x]
        for layer in tm.encoder.layers:
            x = layer(x, mask)
            hiddens.append(x)
        penultimate = hiddens[-((clip_skip or 0) + 2)]
        last = tm.final_layer_norm(x)
        # hidden state at the FIRST eos token of each sequence
        eos_pos = (input_ids == self.config.eos_token_id).int().argmax(dim=-1)
        pooled = last[torch.arange(b, device=x.device), eos_pos]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return CLIPTextOutput(last_hidden_state=last,
                              penultimate_hidden_state=penultimate,
                              pooled_output=pooled)
