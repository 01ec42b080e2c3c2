"""Model architecture configs.

A copy of ``cfgpp_tpu/configs.py``, so that the port imports nothing of the
JAX package; ``tests/test_torch_port_copies.py`` holds the two equal, entry
by entry.  Field values mirror the HF checkpoint configs the reference loads
(`latent_diffusion.py:63-69`, `latent_sdxl.py:40-56`).  Tiny presets
exist so solver/engine integration tests run in seconds without weights.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
    )
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    num_attention_heads: Tuple[int, ...] = (8, 8, 8, 8)
    cross_attention_dim: int = 768
    use_linear_projection: bool = False
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    # SDXL micro-conditioning (added text+time embedding).
    addition_embed_type: Optional[str] = None      # None | "text_time"
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    # "epsilon" (SD1.5/SD2-base/SDXL) or "v_prediction" (SD2.x-768v).
    # v outputs are converted to eps at the eps_fn boundary so every solver
    # works unchanged: eps = sqrt(abar_t) * v + sqrt(1-abar_t) * x_t.
    prediction_type: str = "epsilon"

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"                 # "quick_gelu" | "gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: Optional[int] = None           # set -> adds text_projection
    eos_token_id: int = 49407


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    sample_size: int = 512

    @property
    def scale_factor(self) -> int:
        """Spatial down-factor: 2^(len(blocks)-1). latent_sdxl.py:52."""
        return 2 ** (len(self.block_out_channels) - 1)


@dataclasses.dataclass(frozen=True)
class ModelBundleConfig:
    """One text-to-image model family: UNet + text encoder(s) + VAE."""
    name: str
    family: str                     # "sd" | "sdxl"
    unet: UNetConfig
    vae: VAEConfig
    text_encoder: CLIPTextConfig
    text_encoder_2: Optional[CLIPTextConfig] = None
    default_resolution: int = 512


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------

def sd15_config() -> ModelBundleConfig:
    """runwayml/stable-diffusion-v1-5 (latent_diffusion.py:57)."""
    return ModelBundleConfig(
        name="sd15",
        family="sd",
        unet=UNetConfig(),
        vae=VAEConfig(),
        text_encoder=CLIPTextConfig(),
        default_resolution=512,
    )


def sd21_config() -> ModelBundleConfig:
    """stabilityai/stable-diffusion-2-1 (the reference's `--model sd20` flag
    silently ran SD-1.5 — a documented quirk we fix by actually wiring SD-2.x)."""
    return ModelBundleConfig(
        name="sd21",
        family="sd",
        unet=UNetConfig(
            sample_size=96,
            num_attention_heads=(5, 10, 20, 20),
            cross_attention_dim=1024,
            use_linear_projection=True,
        ),
        vae=VAEConfig(),
        text_encoder=CLIPTextConfig(
            hidden_size=1024, num_layers=23, num_heads=16, intermediate_size=4096,
            hidden_act="gelu",
        ),
        default_resolution=768,
    )


def sd21_v_config() -> ModelBundleConfig:
    """stabilityai/stable-diffusion-2-1 at 768 (v-prediction)."""
    cfg = sd21_config()
    return dataclasses.replace(
        cfg, name="sd21_v",
        unet=dataclasses.replace(cfg.unet, prediction_type="v_prediction"))


def sdxl_config() -> ModelBundleConfig:
    """stabilityai/stable-diffusion-xl-base-1.0 (latent_sdxl.py:35-56)."""
    return ModelBundleConfig(
        name="sdxl",
        family="sdxl",
        unet=UNetConfig(
            sample_size=128,
            block_out_channels=(320, 640, 1280),
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
            transformer_layers_per_block=(1, 2, 10),
            num_attention_heads=(5, 10, 20),
            cross_attention_dim=2048,
            use_linear_projection=True,
            addition_embed_type="text_time",
        ),
        vae=VAEConfig(scaling_factor=0.13025, sample_size=1024),
        text_encoder=CLIPTextConfig(),
        text_encoder_2=CLIPTextConfig(
            hidden_size=1280, num_layers=32, num_heads=20, intermediate_size=5120,
            hidden_act="gelu", projection_dim=1280,
        ),
        default_resolution=1024,
    )


def sdxl_lightning_config() -> ModelBundleConfig:
    """SDXL-Lightning distilled UNet: same architecture, different weights
    (latent_sdxl.py:366-418)."""
    cfg = sdxl_config()
    return dataclasses.replace(cfg, name="sdxl_lightning")


def tiny_sd_config() -> ModelBundleConfig:
    """Second-scale fake model for integration tests (SURVEY.md §4)."""
    return ModelBundleConfig(
        name="tiny_sd",
        family="sd",
        unet=UNetConfig(
            sample_size=8,
            block_out_channels=(32, 64),
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            layers_per_block=1,
            transformer_layers_per_block=(1, 1),
            num_attention_heads=(2, 2),
            cross_attention_dim=32,
            norm_num_groups=8,
        ),
        vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8,
                      sample_size=64),
        text_encoder=CLIPTextConfig(
            vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, eos_token_id=999,
        ),
        default_resolution=64,
    )


def tiny_sdxl_config() -> ModelBundleConfig:
    """Tiny SDXL-shaped model: dual encoders + text_time micro-conditioning."""
    return ModelBundleConfig(
        name="tiny_sdxl",
        family="sdxl",
        unet=UNetConfig(
            sample_size=8,
            block_out_channels=(32, 64),
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
            layers_per_block=1,
            transformer_layers_per_block=(1, 2),
            num_attention_heads=(2, 2),
            cross_attention_dim=80,   # = concat of the two encoders (32 + 48)
            use_linear_projection=True,
            norm_num_groups=8,
            addition_embed_type="text_time",
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=8 * 6 + 48,
        ),
        vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8,
                      scaling_factor=0.13025, sample_size=64),
        text_encoder=CLIPTextConfig(
            vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, eos_token_id=999,
        ),
        text_encoder_2=CLIPTextConfig(
            vocab_size=1000, hidden_size=48, num_layers=2, num_heads=2,
            intermediate_size=96, hidden_act="gelu", projection_dim=48, eos_token_id=999,
        ),
        default_resolution=64,
    )


_PRESETS = {
    "sd15": sd15_config,
    "sd20": sd21_config,   # reference CLI accepts sd20; we map it to SD-2.1 for real
    "sd21": sd21_config,
    "sd21_v": sd21_v_config,
    "sdxl": sdxl_config,
    "sdxl_lightning": sdxl_lightning_config,
    "tiny_sd": tiny_sd_config,
    "tiny_sdxl": tiny_sdxl_config,
}


def get_bundle_config(name: str) -> ModelBundleConfig:
    if name not in _PRESETS:
        raise ValueError(f"unknown model {name!r}; available: {sorted(_PRESETS)}")
    return _PRESETS[name]()
