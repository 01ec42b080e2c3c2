"""The SD / SDXL UNet family (``sd15``, ``sd21``, ``sdxl``, SDXL-Lightning's
weights): CLIP text towers (SDXL: two), a UNet over a 4-channel latent with
an epsilon- or v-prediction DDPM schedule, and the VAE decoder.  A
configuration file without ``"family"`` is of this family.

The program is the port's `DiffusionEngine` over a `ModelBundle` of the
port's `UNet2DConditionModel`, `AutoencoderKL` and `CLIPTextModel`; the
reference is ``bench_port/reference/``.  What each function provides:
``bench_port/families/__init__.py``.
"""

from __future__ import annotations

from typing import Dict

import torch

from bench_port import weights
from bench_port.families.sd_unet.flops import attention_sites, unit_flops
from bench_port.reference.models import set_ops
from bench_port.reference.pipeline import Reference

__all__ = ["MODULES", "check_config", "build", "with_nfe", "spans",
           "reference", "set_ops", "compute_dtypes", "unit_flops",
           "attention_sites"]

MODULES = {"unet": 1, "vae": 2, "text_encoder": 3, "text_encoder_2": 4}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def check_config(config: Dict) -> None:
    """The port's preset must be the configuration file, key by key."""
    from cfgpp_tpu_torch.configs import get_bundle_config
    port_cfg = get_bundle_config(config["preset"])
    for part in MODULES:
        ours = config.get(part)
        theirs = getattr(port_cfg, part)
        if (ours is None) != (theirs is None):
            raise ValueError(f"{config['name']}: {part} present on one side")
        if ours is None:
            continue
        for key, value in ours.items():
            got = getattr(theirs, key)
            got = list(got) if isinstance(got, tuple) else got
            if got != value:
                raise ValueError(f"{config['name']}.{part}.{key}: the port's "
                                 f"preset has {got!r}, the file {value!r}")


def build(config: Dict, mix: Dict, seed: int, device):
    """The port's engine: each module made on the meta device, filled on
    ``device`` from the seed in the dtype it is served in, then the bundle
    quantized as the mix says (its int8 weights made from those)."""
    from cfgpp_tpu_torch.configs import get_bundle_config
    from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
    from cfgpp_tpu_torch.models.clip import CLIPTextModel
    from cfgpp_tpu_torch.models.unet import UNet2DConditionModel
    from cfgpp_tpu_torch.models.vae import AutoencoderKL
    from cfgpp_tpu_torch.weights.tokenizer import load_tokenizer

    device = torch.device(device)
    cfg = get_bundle_config(config["preset"])
    dt = {k: DTYPES[v] for k, v in config["dtypes"].items()}
    with torch.device("meta"):
        made = {"unet": UNet2DConditionModel(cfg.unet).to(dt["unet"]),
                "vae": AutoencoderKL(cfg.vae, compute_dtype=dt[
                    "vae_decode_compute"]).to(dt["vae"]),
                "text_encoder": CLIPTextModel(cfg.text_encoder).to(
                    dt["text_encoder"])}
        if cfg.text_encoder_2 is not None:
            made["text_encoder_2"] = CLIPTextModel(
                cfg.text_encoder_2).to(dt["text_encoder_2"])
    mods = {}
    for name, m in made.items():
        m = m.to_empty(device=device).eval().requires_grad_(False)
        mods[name] = weights.fill_(m, seed, name, dt[name], MODULES)

    def tok(part, pad=None):
        c = getattr(cfg, part)
        return load_tokenizer(None, vocab_size=c.vocab_size,
                              eos_token_id=c.eos_token_id, pad_token_id=pad)

    bundle = ModelBundle(
        config=cfg, unet=mods["unet"], vae=mods["vae"],
        text_encoder=mods["text_encoder"], tokenizer=tok("text_encoder"),
        text_encoder_2=mods.get("text_encoder_2"),
        tokenizer_2=(tok("text_encoder_2", 0) if "text_encoder_2" in mods
                     else None))
    if mix["quant"]:
        bundle = bundle.quantized(mix["quant"])
    return DiffusionEngine(bundle, solver=mix["solver"], nfe=mix["nfe"])


def with_nfe(engine, mix: Dict, nfe: int):
    from cfgpp_tpu_torch.engine import DiffusionEngine
    return DiffusionEngine(engine.bundle, solver=mix["solver"], nfe=nfe)


def spans(program):
    """The engine's text encode, the UNet module's ``forward`` and the
    VAE's ``decode``."""
    bundle = program.engine.bundle
    return [(program.engine, "text_embed", "text"),
            (bundle.unet, "forward", "unet"),
            (bundle.vae, "decode", "vae")]


def reference(config: Dict, device, ops=None, quant=None) -> Reference:
    return Reference(config, device, ops, quant)


def compute_dtypes(config: Dict) -> Dict[str, str]:
    """The UNet and the text encoders compute in their weights' dtype, the
    VAE decoder in ``vae_decode_compute``."""
    dtypes = config["dtypes"]
    return {name: dtypes["vae_decode_compute"] if name == "vae"
            else dtypes[name] for name in MODULES if name in dtypes}
