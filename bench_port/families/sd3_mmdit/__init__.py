"""The SD3 family (``sd35_large``): CLIP-L and CLIP-G text towers and T5
v1.1's encoder, an MMDiT over a 16-channel latent (joint attention over the
image and text tokens) sampled by a flow-matching Euler loop (CFG or
CFG++), and the VAE decoder with a shift and no post-quant conv.

The program is the port's `SD3Engine` over an `SD3Bundle`
(``cfgpp_tpu_torch/engine/sd3.py``); the reference is ``plain.py``
here.  What each function provides: ``bench_port/families/__init__.py``.
"""

from __future__ import annotations

from typing import Dict

import torch

from bench_port import weights
from bench_port.families.sd3_mmdit.flops import attention_sites, unit_flops
from bench_port.families.sd3_mmdit.plain import Reference
from bench_port.reference.models import set_ops

__all__ = ["MODULES", "check_config", "build", "with_nfe", "spans",
           "reference", "set_ops", "compute_dtypes", "unit_flops",
           "attention_sites"]

MODULES = {"transformer": 6, "vae": 2, "text_encoder": 3,
           "text_encoder_2": 4, "text_encoder_3": 7}
PARTS = tuple(MODULES) + ("scheduler",)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def check_config(config: Dict) -> None:
    """The port's SD3 preset must be the configuration file, key by key."""
    from cfgpp_tpu_torch.configs_sd3 import get_sd3_config
    port = get_sd3_config(config["preset"])
    for part in PARTS:
        for key, value in config[part].items():
            got = getattr(getattr(port, part), key)
            got = list(got) if isinstance(got, tuple) else got
            if got != value:
                raise ValueError(f"{config['name']}.{part}.{key}: the port's "
                                 f"preset has {got!r}, the file {value!r}")
    if port.max_sequence_length != config["max_sequence_length"]:
        raise ValueError(f"{config['name']}.max_sequence_length: the port's "
                         f"preset has {port.max_sequence_length}")


def build(config: Dict, mix: Dict, seed: int, device):
    """The port's engine: the bundle's modules made on the meta device,
    then filled on ``device`` from the seed in the dtypes they are served
    in."""
    from cfgpp_tpu_torch.engine.sd3 import SD3Bundle, SD3Engine

    if mix["quant"]:
        raise ValueError("the SD3 family has no int8 mode")
    dt = {k: DTYPES[v] for k, v in config["dtypes"].items()}
    bundle = SD3Bundle.empty(config["preset"], dt, device)
    for name in MODULES:
        weights.fill_(getattr(bundle, name), seed, name, dt[name], MODULES)
    return SD3Engine(bundle, solver=mix["solver"], nfe=mix["nfe"])


def with_nfe(engine, mix: Dict, nfe: int):
    from cfgpp_tpu_torch.engine.sd3 import SD3Engine
    return SD3Engine(engine.bundle, solver=mix["solver"], nfe=nfe)


def spans(program):
    """The engine's text encode, the MMDiT's and T5's ``forward`` and the
    VAE's ``decode``."""
    bundle = program.engine.bundle
    return [(program.engine, "text_embed", "text"),
            (bundle.transformer, "forward", "mmdit"),
            (bundle.text_encoder_3, "forward", "t5"),
            (bundle.vae, "decode", "vae")]


def reference(config: Dict, device, ops=None, quant=None) -> Reference:
    if quant:
        raise ValueError("the SD3 family has no int8 mode")
    return Reference(config, device, ops)


def compute_dtypes(config: Dict) -> Dict[str, str]:
    """The MMDiT and the text encoders compute in their weights' dtype, the
    VAE decoder in ``vae_decode_compute``."""
    dtypes = config["dtypes"]
    return {name: dtypes["vae_decode_compute"] if name == "vae"
            else dtypes[name] for name in MODULES}
