"""Single-file (SGM/LDM layout) checkpoints -> the port's modules.
Counterpart of ``cfgpp_tpu/weights/single_file.py``.

SDXL-Lightning ships as one safetensors file in StabilityAI's SGM key
layout (``model.diffusion_model.*``, ``first_stage_model.*``,
``conditioner.embedders.*``).  This module renames those keys to the
port's diffusers / transformers names; the tensors keep their torch
layouts, except two:

* the LDM VAE's mid-block attention q/k/v/proj_out are 1x1 convs
  ``[C, C, 1, 1]``, squeezed to the port's linear ``[C, C]``;
* OpenCLIP's ``text_projection`` is a parameter used as ``x @ W`` (``[in,
  out]``), transposed into the port's ``nn.Linear`` weight ``[out, in]``;
  its fused ``in_proj`` is split into q/k/v.

The SGM UNet numbers its blocks sequentially (``input_blocks.k``,
``output_blocks.k``); `_unet_layout` derives the numbering from the UNet
config exactly as the JAX module does.  Keys under none of the three
prefixes are ignored; an unknown key under one raises ``KeyError``.  Every
part must be in the file, as in the JAX loader: a UNet-only file has no
CLIP keys and raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

from cfgpp_tpu_torch.configs import ModelBundleConfig, UNetConfig
from cfgpp_tpu_torch.weights.convert import clip_text_from_hf, load_module_
from cfgpp_tpu_torch.weights.safetensors_io import load_file

StateDict = Dict[str, torch.Tensor]
UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."
CLIP_PREFIX = "conditioner.embedders.0.transformer."
OPENCLIP_PREFIX = "conditioner.embedders.1.model."

_RESNET = {"in_layers.0": "norm1", "in_layers.2": "conv1",
           "emb_layers.1": "time_emb_proj", "out_layers.0": "norm2",
           "out_layers.3": "conv2", "skip_connection": "conv_shortcut"}


def _resnet_key(rest: str) -> str:
    for sgm, ours in _RESNET.items():
        if rest.startswith(sgm + "."):
            return ours + rest[len(sgm):]
    raise KeyError(f"unhandled SGM resnet key: {rest}")


def _unet_layout(cfg: UNetConfig):
    """Sequential SGM block ids -> (our block name, kind) for input/output."""
    n_levels = len(cfg.block_out_channels)
    inputs = {}   # sgm idx -> ("block" | "down", level, j, has_attn)
    idx = 1
    for i, btype in enumerate(cfg.down_block_types):
        has_attn = btype == "CrossAttnDownBlock2D"
        for j in range(cfg.layers_per_block):
            inputs[idx] = ("block", i, j, has_attn)
            idx += 1
        if i < n_levels - 1:
            inputs[idx] = ("down", i, 0, False)
            idx += 1
    outputs = {}
    idx = 0
    for i, btype in enumerate(cfg.up_block_types):
        has_attn = btype == "CrossAttnUpBlock2D"
        for j in range(cfg.layers_per_block + 1):
            has_up = (i < n_levels - 1) and (j == cfg.layers_per_block)
            outputs[idx] = ("block", i, j, has_attn, has_up)
            idx += 1
    return inputs, outputs


def convert_sgm_unet(state: Mapping[str, torch.Tensor],
                     cfg: UNetConfig) -> StateDict:
    """The ``model.diffusion_model.*`` keys -> a diffusers UNet state dict."""
    inputs, outputs = _unet_layout(cfg)
    out: StateDict = {}
    for key, value in state.items():
        if not key.startswith(UNET_PREFIX):
            continue
        k = key[len(UNET_PREFIX):]
        m = re.match(r"^(time_embed|label_emb\.0)\.(0|2)\.(weight|bias)$", k)
        if m:
            top = "time_embedding" if m[1] == "time_embed" else "add_embedding"
            out[f"{top}.linear_{1 if m[2] == '0' else 2}.{m[3]}"] = value
            continue
        m = re.match(r"^input_blocks\.0\.0\.(weight|bias)$", k)
        if m:
            out[f"conv_in.{m[1]}"] = value
            continue
        m = re.match(r"^input_blocks\.(\d+)\.(\d+)\.(.*)$", k)
        if m:
            what, lvl, j, _ = inputs[int(m[1])]
            inner, rest = int(m[2]), m[3]
            if what == "down":
                if not rest.startswith("op."):
                    raise KeyError(f"unhandled SGM UNet key: {key}")
                out[f"down_blocks.{lvl}.downsamplers.0.conv."
                    f"{rest[len('op.'):]}"] = value
            elif inner == 0:
                out[f"down_blocks.{lvl}.resnets.{j}.{_resnet_key(rest)}"] = value
            else:
                out[f"down_blocks.{lvl}.attentions.{j}.{rest}"] = value
            continue
        m = re.match(r"^middle_block\.(0|1|2)\.(.*)$", k)
        if m:
            if m[1] == "1":
                out[f"mid_block.attentions.0.{m[2]}"] = value
            else:
                out[f"mid_block.resnets.{0 if m[1] == '0' else 1}."
                    f"{_resnet_key(m[2])}"] = value
            continue
        m = re.match(r"^output_blocks\.(\d+)\.(\d+)\.(.*)$", k)
        if m:
            _, lvl, j, has_attn, has_up = outputs[int(m[1])]
            inner, rest = int(m[2]), m[3]
            if has_up and inner == (2 if has_attn else 1):
                if not rest.startswith("conv."):
                    raise KeyError(f"unhandled SGM UNet key: {key}")
                out[f"up_blocks.{lvl}.upsamplers.0.{rest}"] = value
            elif inner == 0:
                out[f"up_blocks.{lvl}.resnets.{j}.{_resnet_key(rest)}"] = value
            else:
                out[f"up_blocks.{lvl}.attentions.{j}.{rest}"] = value
            continue
        m = re.match(r"^out\.(0|2)\.(weight|bias)$", k)
        if m:
            out[f"{'conv_norm_out' if m[1] == '0' else 'conv_out'}.{m[2]}"] = value
            continue
        raise KeyError(f"unhandled SGM UNet key: {key}")
    return out


_LDM_ATTN = {"q": "to_q", "k": "to_k", "v": "to_v", "proj_out": "to_out.0",
             "norm": "group_norm"}


def _ldm_resnet(rest: str) -> str:
    name, kind = rest.split(".")
    return f"{'conv_shortcut' if name == 'nin_shortcut' else name}.{kind}"


def convert_ldm_vae(state: Mapping[str, torch.Tensor],
                    n_levels: int) -> StateDict:
    """The ``first_stage_model.*`` keys -> a diffusers AutoencoderKL state
    dict.  LDM's ``decoder.up`` is indexed in reverse (``up.0`` is the
    lowest resolution, our ``up_blocks.{n_levels - 1}``)."""
    out: StateDict = {}
    for key, value in state.items():
        if not key.startswith(VAE_PREFIX):
            continue
        k = key[len(VAE_PREFIX):]
        if k.startswith(("quant_conv.", "post_quant_conv.")):
            out[k] = value
            continue
        m = re.match(r"^(encoder|decoder)\.(.*)$", k)
        if not m:
            raise KeyError(f"unhandled LDM VAE key: {key}")
        side, rest = m[1], m[2]
        if re.match(r"^conv_(in|out)\.(weight|bias)$", rest):
            out[f"{side}.{rest}"] = value
            continue
        mm = re.match(r"^norm_out\.(weight|bias)$", rest)
        if mm:
            out[f"{side}.conv_norm_out.{mm[1]}"] = value
            continue
        mm = re.match(r"^mid\.(block_1|attn_1|block_2)\.(.*)$", rest)
        if mm:
            if mm[1] == "attn_1":
                name, kind = mm[2].split(".")
                if value.ndim == 4:       # 1x1 conv [C, C, 1, 1] -> [C, C]
                    value = value[:, :, 0, 0].contiguous()
                out[f"{side}.mid_block.attentions.0.{_LDM_ATTN[name]}."
                    f"{kind}"] = value
            else:
                j = 0 if mm[1] == "block_1" else 1
                out[f"{side}.mid_block.resnets.{j}.{_ldm_resnet(mm[2])}"] = value
            continue
        mm = re.match(r"^(down|up)\.(\d+)\.(block|downsample|upsample)\.(.*)$",
                      rest)
        if mm:
            lvl = int(mm[2])
            if mm[1] == "up":
                lvl = n_levels - 1 - lvl
            blocks = f"{side}.{mm[1]}_blocks.{lvl}"
            if mm[3] == "block":
                j, leaf = mm[4].split(".", 1)
                out[f"{blocks}.resnets.{j}.{_ldm_resnet(leaf)}"] = value
            else:
                if not mm[4].startswith("conv."):
                    raise KeyError(f"unhandled LDM VAE key: {key}")
                out[f"{blocks}.{mm[1]}samplers.0.{mm[4]}"] = value
            continue
        raise KeyError(f"unhandled LDM VAE key: {key}")
    return out


_OPENCLIP_LAYER = {"attn.out_proj": "self_attn.out_proj", "ln_1": "layer_norm1",
                   "ln_2": "layer_norm2", "mlp.c_fc": "mlp.fc1",
                   "mlp.c_proj": "mlp.fc2"}


def convert_openclip_text(state: Mapping[str, torch.Tensor],
                          prefix: str = OPENCLIP_PREFIX) -> StateDict:
    """OpenCLIP text keys under ``prefix`` -> a transformers
    CLIPTextModelWithProjection state dict."""
    out: StateDict = {}
    for key, value in state.items():
        if not key.startswith(prefix):
            continue
        k = key[len(prefix):]
        if k == "token_embedding.weight":
            out["text_model.embeddings.token_embedding.weight"] = value
        elif k == "positional_embedding":
            out["text_model.embeddings.position_embedding.weight"] = value
        elif k == "text_projection":
            # a parameter used as x @ W, [in, out]: nn.Linear holds [out, in]
            out["text_projection.weight"] = value.t().contiguous()
        elif k in ("ln_final.weight", "ln_final.bias"):
            out[f"text_model.final_layer_norm.{k.split('.')[1]}"] = value
        elif k == "logit_scale":
            continue
        else:
            m = re.match(r"^transformer\.resblocks\.(\d+)\.(.*)$", k)
            if not m:
                raise KeyError(f"unhandled OpenCLIP key: {key}")
            layer, rest = f"text_model.encoder.layers.{m[1]}", m[2]
            if rest in ("attn.in_proj_weight", "attn.in_proj_bias"):
                kind = "weight" if rest.endswith("weight") else "bias"
                for name, t in zip(("q_proj", "k_proj", "v_proj"),
                                   value.chunk(3, dim=0)):
                    out[f"{layer}.self_attn.{name}.{kind}"] = t.contiguous()
                continue
            for sgm, ours in _OPENCLIP_LAYER.items():
                if rest.startswith(sgm + "."):
                    out[f"{layer}.{ours}{rest[len(sgm):]}"] = value
                    break
            else:
                raise KeyError(f"unhandled OpenCLIP key: {key}")
    return out


def convert_single_file(state: Mapping[str, torch.Tensor],
                        config: ModelBundleConfig) -> Dict[str, StateDict]:
    """A full single-file SDXL checkpoint -> {"unet", "vae", "text" and,
    with a second encoder, "text2"}: one state dict per module."""
    clip1 = {k[len(CLIP_PREFIX):]: v for k, v in state.items()
             if k.startswith(CLIP_PREFIX)}
    out = {
        "unet": convert_sgm_unet(state, config.unet),
        "vae": convert_ldm_vae(state, len(config.vae.block_out_channels)),
        "text": clip_text_from_hf(clip1),
    }
    if config.text_encoder_2 is not None:
        out["text2"] = convert_openclip_text(state)
    return out


def load_single_file(bundle, checkpoint_path):
    """Fill an SDXL(-Lightning) bundle from one SGM safetensors file (the
    reference's ``from_single_file``, ``latent_sdxl.py:390``), each module
    checked against its structure and cast to its dtypes."""
    trees = convert_single_file(load_file(checkpoint_path), bundle.config)
    load_module_(bundle.unet, trees["unet"], "unet(single-file)")
    load_module_(bundle.vae, trees["vae"], "vae(single-file)")
    load_module_(bundle.text_encoder, trees["text"], "text(single-file)")
    if "text2" in trees:
        load_module_(bundle.text_encoder_2, trees["text2"],
                     "text2(single-file)")
    return bundle
