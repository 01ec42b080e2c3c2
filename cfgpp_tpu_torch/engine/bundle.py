"""ModelBundle: a model family's modules + tokenizer, ready to run on one
device.  Counterpart of ``cfgpp_tpu/engine/bundle.py``.

Where the JAX bundle keeps Flax modules and parameter trees apart, here the
parameters live in the `nn.Module`s.  Dtype policy, as in the JAX bundle:

* UNet: parameters and compute in ``dtype`` (bf16 on the card);
* VAE: f32 parameters; decode computes in bf16 unless ``dtype`` is f32
  (``cfgpp_tpu/engine/bundle.py:96-105``), with f32 GroupNorm statistics;
* CLIP text encoder: f32 (``bundle.py:107``); SDXL's second one
  (``text_encoder_2``, with its projection) f32 too, and its tokenizer pads
  with id 0, not EOS (``bundle.py:112-119``).

Bundles come from `random_init` (seeded random weights; benchmarks and the
chip smoke run), `from_pretrained` (an HF-layout safetensors directory,
through `cfgpp_tpu_torch.weights.convert`; `weights.checkpoint` writes
one), `from_single_file` (an SGM single file, `weights.single_file`) or
`from_flax` (the JAX package's parameter trees, through
`cfgpp_tpu_torch.weights.bridge`; the parity tests).  `quantized` gives the
opt-in int8 W8A8 UNet (`cfgpp_tpu_torch.weights.quantize`, modes "dense" and
"all"): its int8 weights, scales and biases are made after the dtype cast,
so scales and biases stay f32 as in the JAX tree.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Mapping, Optional, Union

import torch
from torch import nn

from cfgpp_tpu_torch.configs import ModelBundleConfig, get_bundle_config
from cfgpp_tpu_torch.weights.tokenizer import load_tokenizer
from cfgpp_tpu_torch.models.clip import CLIPTextModel
from cfgpp_tpu_torch.models.unet import UNet2DConditionModel
from cfgpp_tpu_torch.models.vae import AutoencoderKL
from cfgpp_tpu_torch.weights.bridge import (clip_text_state_dict,
                                            diffusers_state_dict)
from cfgpp_tpu_torch.weights.quantize import (quantize_unet_,
                                              quantized_structure_)

Device = Union[str, torch.device]


def _device(device: Device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() "
                           "is False")
    return dev


@torch.no_grad()
def _random_init_(module: nn.Module, gen: torch.Generator) -> None:
    """Fill every parameter from ``gen`` the way flax's default initializers
    do: dense and conv kernels lecun-normal (std fan_in^-1/2), biases 0,
    norm scales 1 (scale-only norms too), token embeddings std vocab^-1/2
    (flax ``Embed``), CLIP's position embedding std 0.01
    (``cfgpp_tpu/models/clip.py:91``)."""
    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * std)

    seen = set()
    for name, m in module.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            normal_(m.weight, m.weight[0].numel() ** -0.5)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 0.01 if name.endswith("position_embedding")
                    else m.num_embeddings ** -0.5)
        elif (type(m).__name__.endswith("Norm") and [
                n for n, _ in m.named_parameters(recurse=False)] == ["weight"]):
            m.weight.fill_(1.0)     # a scale-only norm (SD3's RMSNorms, T5's)
        else:
            continue
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()
        seen.update(id(p) for p in m.parameters(recurse=False))
    missed = [n for n, p in module.named_parameters() if id(p) not in seen]
    if missed:
        raise TypeError(f"no initializer for parameters {missed[:5]}")


def _frozen(module: nn.Module) -> nn.Module:
    return module.eval().requires_grad_(False)


@dataclasses.dataclass
class ModelBundle:
    config: ModelBundleConfig
    unet: UNet2DConditionModel
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    tokenizer: Any
    text_encoder_2: Optional[CLIPTextModel] = None
    tokenizer_2: Any = None

    @property
    def family(self) -> str:
        return self.config.family

    @property
    def latent_channels(self) -> int:
        return self.config.vae.latent_channels

    @property
    def vae_scale_factor(self) -> int:
        return self.config.vae.scale_factor

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @classmethod
    def _empty(cls, config_or_name, dtype: torch.dtype, device: torch.device,
               tokenizer_dir: Optional[str]) -> "ModelBundle":
        """Modules with uninitialized parameters on ``device``."""
        cfg = (get_bundle_config(config_or_name)
               if isinstance(config_or_name, str) else config_or_name)
        if cfg.family not in ("sd", "sdxl"):
            raise ValueError(f"the PyTorch port covers the sd family (SD-1.5 "
                             f"and SD-2.x) and sdxl; got {cfg.name} "
                             f"({cfg.family})")
        if cfg.family == "sdxl" and cfg.text_encoder_2 is None:
            raise ValueError(f"{cfg.name}: an sdxl bundle needs text_encoder_2")
        vae_dtype = torch.float32 if dtype == torch.float32 else torch.bfloat16
        with torch.device("meta"):
            unet = UNet2DConditionModel(cfg.unet)
            vae = AutoencoderKL(cfg.vae, compute_dtype=vae_dtype)
            text = CLIPTextModel(cfg.text_encoder)
            text2 = (CLIPTextModel(cfg.text_encoder_2)
                     if cfg.family == "sdxl" else None)
        tok = load_tokenizer(tokenizer_dir, vocab_size=cfg.text_encoder.vocab_size,
                             eos_token_id=cfg.text_encoder.eos_token_id)
        tok2 = None
        if text2 is not None:
            text2 = _frozen(text2.to_empty(device=device))
            tok2 = load_tokenizer(
                tokenizer_dir, vocab_size=cfg.text_encoder_2.vocab_size,
                eos_token_id=cfg.text_encoder_2.eos_token_id, pad_token_id=0)
        return cls(config=cfg,
                   unet=_frozen(unet.to_empty(device=device).to(dtype)),
                   vae=_frozen(vae.to_empty(device=device)),
                   text_encoder=_frozen(text.to_empty(device=device)),
                   tokenizer=tok, text_encoder_2=text2, tokenizer_2=tok2)

    @classmethod
    def random_init(cls, config_or_name, seed: int, dtype: torch.dtype,
                    device: Device,
                    tokenizer_dir: Optional[str] = None) -> "ModelBundle":
        """Seeded random weights, drawn on ``device`` from one generator
        (UNet, then VAE, then text encoder, then SDXL's second one)."""
        dev = _device(device)
        bundle = cls._empty(config_or_name, dtype, dev, tokenizer_dir)
        gen = torch.Generator(device=dev).manual_seed(seed)
        for m in (bundle.unet, bundle.vae, bundle.text_encoder,
                  bundle.text_encoder_2):
            if m is not None:
                _random_init_(m, gen)
        return bundle

    @classmethod
    def from_flax(cls, config_or_name, params: Mapping[str, Any],
                  dtype: torch.dtype, device: Device,
                  tokenizer_dir: Optional[str] = None,
                  quant: Optional[str] = None) -> "ModelBundle":
        """Load the JAX package's ``ModelBundle.params()`` trees ({"unet",
        "vae", "text"} and, for sdxl, "text2"; array-likes) strictly into the
        port's modules.  ``quant``: the mode of a quantized UNet tree (the
        JAX package's ``quantized(mode).params()``)."""
        bundle = cls._empty(config_or_name, dtype, _device(device), tokenizer_dir)
        if quant is not None:
            quantized_structure_(bundle.unet, quant)
        bundle.unet.load_state_dict(diffusers_state_dict(params["unet"]))
        bundle.vae.load_state_dict(diffusers_state_dict(params["vae"]))
        bundle.text_encoder.load_state_dict(clip_text_state_dict(params["text"]))
        if bundle.text_encoder_2 is not None:
            bundle.text_encoder_2.load_state_dict(
                clip_text_state_dict(params["text2"]))
        return bundle

    @classmethod
    def from_pretrained(cls, checkpoint_dir, config_or_name,
                        dtype: torch.dtype = torch.bfloat16,
                        device: Device = "cuda") -> "ModelBundle":
        """Load an HF-layout checkpoint directory (``unet/``, ``vae/``,
        ``text_encoder/`` and, for sdxl, ``text_encoder_2/`` of safetensors
        files; the tokenizer's ``vocab.json``/``merges.txt`` from the
        directory itself, else the fallback tokenizer), as
        ``cfgpp_tpu/engine/bundle.py:from_pretrained`` does.  The modules
        are made without a random draw and filled from the files."""
        from cfgpp_tpu_torch.weights.convert import load_bundle_dir_
        bundle = cls._empty(config_or_name, dtype, _device(device),
                            str(checkpoint_dir))
        load_bundle_dir_(bundle, checkpoint_dir)
        return bundle

    @classmethod
    def from_single_file(cls, checkpoint_path, config_or_name,
                         dtype: torch.dtype = torch.bfloat16,
                         device: Device = "cuda") -> "ModelBundle":
        """Load every module from one SGM single-file checkpoint
        (`cfgpp_tpu_torch.weights.single_file`), without a random draw."""
        from cfgpp_tpu_torch.weights.single_file import load_single_file
        bundle = cls._empty(config_or_name, dtype, _device(device), None)
        return load_single_file(bundle, checkpoint_path)

    def quantized(self, mode: str = "dense") -> "ModelBundle":
        """A bundle whose UNet is an int8 W8A8 copy of this one's
        (``cfgpp_tpu/engine/bundle.py:quantized``); this bundle keeps its
        exact UNet.  ``mode="dense"``: the transformer projections;
        ``mode="all"``: also the resnet and upsampler convs and the
        self-attention score.  Both text encoders are shared."""
        unet = quantize_unet_(copy.deepcopy(self.unet), mode)
        return dataclasses.replace(self, unet=unet)
