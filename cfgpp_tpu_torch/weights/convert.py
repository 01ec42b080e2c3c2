"""HF-layout checkpoints -> the port's modules.  Counterpart of
``cfgpp_tpu/weights/convert.py``.

The port's modules carry the diffusers (UNet, VAE) and transformers (CLIP
text) parameter names and layouts, so an HF state dict loads almost as it
stands.  What is left are the JAX converter's own rules:

* the VAE's legacy attention names ``query``/``key``/``value``/
  ``proj_attn`` are ``to_q``/``to_k``/``to_v``/``to_out.0``
  (``cfgpp_tpu/weights/convert.py:105-116``);
* a CLIP file's ``position_ids``, and the vision tower and ``logit_scale``
  of a combined CLIPModel file, are skipped; any other key outside
  ``text_model.*`` / ``text_projection`` raises, and so does a file with no
  ``text_model.*`` key (``convert.py:154-189``);
* the structural check: missing, extra and shape-mismatched names raise
  (``convert.py:245-257``);
* each tensor is cast to the dtype of the parameter it fills.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping

import torch
from torch import nn

from cfgpp_tpu_torch.weights.safetensors_io import load_file

StateDict = Dict[str, torch.Tensor]
_LEGACY_VAE = {"query": "to_q", "key": "to_k", "value": "to_v",
               "proj_attn": "to_out.0"}
_CLIP_SKIPPED = ("vision_model.", "visual_projection")


def vae_from_hf(state: Mapping[str, torch.Tensor]) -> StateDict:
    """A diffusers AutoencoderKL state dict, legacy attention names
    renamed."""
    return {".".join(_LEGACY_VAE.get(p, p) for p in k.split(".")): v
            for k, v in state.items()}


def clip_text_from_hf(state: Mapping[str, torch.Tensor]) -> StateDict:
    """The text half of a transformers CLIPTextModel[WithProjection] or
    CLIPModel state dict."""
    out: StateDict = {}
    for key, value in state.items():
        if key.endswith("position_ids") or key == "logit_scale" \
                or key.startswith(_CLIP_SKIPPED):
            continue
        if not key.startswith("text_model.") and key != "text_projection.weight":
            raise KeyError(f"unhandled CLIP key: {key}")
        out[key] = value
    if not any(k.startswith("text_model.") for k in out):
        raise KeyError("no text_model.* keys found in the CLIP state dict")
    return out


def validate_structure(state: Mapping[str, torch.Tensor], module: nn.Module,
                       what: str) -> None:
    """``state`` must hold exactly the module's state-dict names, each at
    its shape."""
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"{what}: converted params mismatch; "
                         f"missing={missing[:10]} extra={extra[:10]}")
    bad = [(k, got[k], want[k]) for k in want if got[k] != want[k]]
    if bad:
        raise ValueError(f"{what}: shape mismatches (first 5): {bad[:5]}")


@torch.no_grad()
def load_module_(module: nn.Module, state: Mapping[str, torch.Tensor],
                 what: str) -> None:
    """Check ``state`` against ``module``'s structure, cast each tensor to
    the dtype of what it fills and load it strictly on the module's
    device."""
    validate_structure(state, module, what)
    own = module.state_dict()
    module.load_state_dict({k: v.to(own[k].device, own[k].dtype)
                            for k, v in state.items()}, strict=True)


def read_safetensors_dir(path: Path) -> StateDict:
    """Every ``*.safetensors`` file of ``path`` merged, in sorted order."""
    state: StateDict = {}
    for f in sorted(Path(path).glob("*.safetensors")):
        state.update(load_file(f))
    if not state:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    return state


def load_bundle_dir_(bundle, checkpoint_dir) -> None:
    """Fill a bundle's modules from an HF-layout checkpoint directory (subdirs
    ``unet/``, ``vae/``, ``text_encoder/`` and, for sdxl,
    ``text_encoder_2/``)."""
    root = Path(checkpoint_dir)
    load_module_(bundle.unet, read_safetensors_dir(root / "unet"), "unet")
    load_module_(bundle.vae, vae_from_hf(read_safetensors_dir(
        root / "vae")), "vae")
    load_module_(bundle.text_encoder, clip_text_from_hf(
        read_safetensors_dir(root / "text_encoder")), "text_encoder")
    if bundle.text_encoder_2 is not None:
        load_module_(bundle.text_encoder_2, clip_text_from_hf(
            read_safetensors_dir(root / "text_encoder_2")), "text_encoder_2")
