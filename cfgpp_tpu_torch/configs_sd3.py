"""Stable Diffusion 3 configs: the MMDiT, T5's encoder, the 16-channel VAE
and the flow-matching schedule, with the presets ``sd35_large`` and
``tiny_sd3``.

Apart from ``configs.py`` because that module is a copy of the JAX
package's, which has no SD3 model.  Field names and values are those of
stabilityai/stable-diffusion-3.5-large's ``transformer/config.json``,
``text_encoder*/config.json``, ``vae/config.json`` and
``scheduler/scheduler_config.json``; the CLIP towers reuse
`configs.CLIPTextConfig` (CLIP-L with its 768-wide projection, CLIP-G).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from cfgpp_tpu_torch.configs import CLIPTextConfig, VAEConfig


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    """diffusers' `SD3Transformer2DModel`."""
    sample_size: int = 128
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 38
    attention_head_dim: int = 64
    num_attention_heads: int = 38
    joint_attention_dim: int = 4096
    caption_projection_dim: int = 2432
    pooled_projection_dim: int = 2048
    pos_embed_max_size: int = 192
    qk_norm: str = "rms_norm"
    dual_attention_layers: Tuple[int, ...] = ()

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


@dataclasses.dataclass(frozen=True)
class T5Config:
    """transformers' `T5EncoderModel` (T5 v1.1: gated GELU, no biases)."""
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"


@dataclasses.dataclass(frozen=True)
class SD3VAEConfig(VAEConfig):
    """The SD3 VAE: 16 latent channels, a shift as well as a scale, and no
    quant / post-quant 1x1 convs."""
    latent_channels: int = 16
    scaling_factor: float = 1.5305
    sample_size: int = 1024
    shift_factor: float = 0.0609
    use_quant_conv: bool = False
    use_post_quant_conv: bool = False


@dataclasses.dataclass(frozen=True)
class FlowScheduleConfig:
    """diffusers' `FlowMatchEulerDiscreteScheduler`."""
    num_train_timesteps: int = 1000
    shift: float = 3.0


@dataclasses.dataclass(frozen=True)
class SD3BundleConfig:
    """One SD3 model: MMDiT + CLIP-L + CLIP-G + T5 + VAE.  The context is
    both CLIPs' penultimate states side by side, zero-padded to T5's width,
    then T5's ``max_sequence_length`` tokens after them."""
    name: str
    transformer: MMDiTConfig
    vae: SD3VAEConfig
    text_encoder: CLIPTextConfig
    text_encoder_2: CLIPTextConfig
    text_encoder_3: T5Config
    scheduler: FlowScheduleConfig = FlowScheduleConfig()
    max_sequence_length: int = 256
    default_resolution: int = 1024
    family: str = "sd3"


def sd35_large_config() -> SD3BundleConfig:
    """stabilityai/stable-diffusion-3.5-large."""
    return SD3BundleConfig(
        name="sd35_large",
        transformer=MMDiTConfig(),
        vae=SD3VAEConfig(),
        text_encoder=CLIPTextConfig(projection_dim=768),
        text_encoder_2=CLIPTextConfig(
            hidden_size=1280, num_layers=32, num_heads=20,
            intermediate_size=5120, hidden_act="gelu", projection_dim=1280),
        text_encoder_3=T5Config(),
    )


def tiny_sd3_config() -> SD3BundleConfig:
    """Second-scale SD3-shaped model for the tests: 2 joint blocks (the last
    ``context_pre_only``), a position table larger than the grid (so the
    crop starts past its first row and column), two CLIPs whose 80
    channels are padded to T5's 96, 16 T5 tokens."""
    return SD3BundleConfig(
        name="tiny_sd3",
        transformer=MMDiTConfig(
            sample_size=8, num_layers=2, attention_head_dim=16,
            num_attention_heads=2, joint_attention_dim=96,
            caption_projection_dim=32, pooled_projection_dim=80,
            pos_embed_max_size=6),
        vae=SD3VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                         norm_num_groups=8, sample_size=16),
        text_encoder=CLIPTextConfig(
            vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, projection_dim=32, eos_token_id=999),
        text_encoder_2=CLIPTextConfig(
            vocab_size=1000, hidden_size=48, num_layers=2, num_heads=2,
            intermediate_size=96, hidden_act="gelu", projection_dim=48,
            eos_token_id=999),
        text_encoder_3=T5Config(
            vocab_size=1000, d_model=96, d_kv=16, d_ff=64, num_layers=2,
            num_heads=2),
        max_sequence_length=16,
        default_resolution=16,
    )


SD3_PRESETS = {
    "sd35_large": sd35_large_config,
    "tiny_sd3": tiny_sd3_config,
}


def get_sd3_config(name: str) -> SD3BundleConfig:
    if name not in SD3_PRESETS:
        raise ValueError(f"unknown SD3 model {name!r}; available: "
                         f"{sorted(SD3_PRESETS)}")
    return SD3_PRESETS[name]()
