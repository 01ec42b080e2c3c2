"""The port's state dicts -> a full SGM/LDM single-file state dict: the
inverse of `cfgpp_tpu_torch.weights.single_file`, written from the key maps
of the SGM layout independently of that module, so that a round trip
through both checks each.

It works on real tensors (the chip smoke run writes a full-width
``sdxl_lightning`` bundle as a single file) and on ``meta`` tensors (the
CPU tests map the full-width ``sdxl`` names and shapes without
materializing them).  Tensors keep their dtype and device; every tensor
out is contiguous, as `cfgpp_tpu_torch.weights.safetensors_io.save_file`
requires.

SGM numbers the UNet's blocks sequentially: ``input_blocks.0`` is conv_in,
then each level's ``layers_per_block`` blocks and, below the last level, its
downsampler, so level i's block j is ``1 + i (L + 1) + j`` and its
downsampler ``1 + i (L + 1) + L``; ``output_blocks`` hold each up level's
``L + 1`` blocks, the upsampler riding the last one, after its resnet (0)
and transformer (1) if it has one.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

StateDict = Dict[str, torch.Tensor]

_RESNET = {"norm1": "in_layers.0", "conv1": "in_layers.2",
           "time_emb_proj": "emb_layers.1", "norm2": "out_layers.0",
           "conv2": "out_layers.3", "conv_shortcut": "skip_connection"}
_VAE_ATTN = {"to_q": "q", "to_k": "k", "to_v": "v", "to_out.0": "proj_out",
             "group_norm": "norm"}
_OPENCLIP_LAYER = {"self_attn.out_proj": "attn.out_proj", "layer_norm1": "ln_1",
                   "layer_norm2": "ln_2", "mlp.fc1": "mlp.c_fc",
                   "mlp.fc2": "mlp.c_proj"}


def _resnet(name: str) -> str:
    module, kind = name.rsplit(".", 1)
    return f"{_RESNET[module]}.{kind}"


def synth_sgm_unet(state: Mapping[str, torch.Tensor],
                   layers_per_block: int) -> StateDict:
    """A diffusers UNet state dict -> its ``model.diffusion_model.*``
    keys."""
    step = layers_per_block + 1
    attn_levels = {int(m[1]) for k in state
                   for m in [re.match(r"^up_blocks\.(\d+)\.attentions\.", k)]
                   if m}
    fixed = {"conv_in": "input_blocks.0.0", "conv_norm_out": "out.0",
             "conv_out": "out.2", "time_embedding.linear_1": "time_embed.0",
             "time_embedding.linear_2": "time_embed.2",
             "add_embedding.linear_1": "label_emb.0.0",
             "add_embedding.linear_2": "label_emb.0.2",
             "mid_block.resnets.0": "middle_block.0",
             "mid_block.attentions.0": "middle_block.1",
             "mid_block.resnets.1": "middle_block.2"}
    out: StateDict = {}
    for key, value in state.items():
        m = re.match(r"^(down|up)_blocks\.(\d+)\.(resnets|attentions|"
                     r"downsamplers|upsamplers)\.(\d+)\.(.*)$", key)
        if m:
            side, i, sub, j, rest = m[1], int(m[2]), m[3], int(m[4]), m[5]
            block = (1 + i * step if side == "down" else i * step) + j
            if sub == "resnets":
                where = f"{block}.0.{_resnet(rest)}"
            elif sub == "attentions":
                where = f"{block}.1.{rest}"
            elif sub == "downsamplers":    # rest: conv.weight / conv.bias
                where = f"{block + layers_per_block}.0.op.{rest[len('conv.'):]}"
            else:                          # the upsampler rides the last block
                up = 2 if i in attn_levels else 1
                where = f"{block + layers_per_block}.{up}.{rest}"
            sgm = f"{'input' if side == 'down' else 'output'}_blocks.{where}"
        else:
            module = next(p for p in fixed if key.startswith(p + "."))
            rest = key[len(module) + 1:]
            if module.startswith("mid_block.resnets"):
                rest = _resnet(rest)
            sgm = f"{fixed[module]}.{rest}"
        out["model.diffusion_model." + sgm] = value.contiguous()
    return out


def synth_ldm_vae(state: Mapping[str, torch.Tensor], n_levels: int) -> StateDict:
    """A diffusers AutoencoderKL state dict -> its ``first_stage_model.*``
    keys: the decoder's up levels reversed, the mid-block attention's q, k,
    v and proj_out as 1x1 conv weights."""
    out: StateDict = {}
    for key, value in state.items():
        side, _, rest = key.partition(".")
        if side in ("quant_conv", "post_quant_conv"):
            ldm = key
        elif rest.startswith("conv_norm_out."):
            ldm = f"{side}.norm_out.{rest.split('.')[-1]}"
        elif rest.startswith("mid_block.attentions.0."):
            module, kind = rest[len("mid_block.attentions.0."):].rsplit(".", 1)
            ldm = f"{side}.mid.attn_1.{_VAE_ATTN[module]}.{kind}"
            if kind == "weight" and module != "group_norm":
                value = value[:, :, None, None]
        elif rest.startswith("mid_block.resnets."):
            j, leaf = rest[len("mid_block.resnets."):].split(".", 1)
            leaf = leaf.replace("conv_shortcut", "nin_shortcut")
            ldm = f"{side}.mid.block_{int(j) + 1}.{leaf}"
        else:
            m = re.match(r"^(down|up)_blocks\.(\d+)\.(resnets\.\d+|"
                         r"downsamplers\.0|upsamplers\.0)\.(.*)$", rest)
            if m is None:
                ldm = key                      # conv_in, conv_out
            else:
                lvl = int(m[2]) if m[1] == "down" else n_levels - 1 - int(m[2])
                where = (f"block.{m[3].split('.')[1]}"
                         if m[3].startswith("resnets") else f"{m[1]}sample")
                leaf = m[4].replace("conv_shortcut", "nin_shortcut")
                ldm = f"{side}.{m[1]}.{lvl}.{where}.{leaf}"
        out["first_stage_model." + ldm] = value.contiguous()
    return out


def synth_hf_clip(state: Mapping[str, torch.Tensor]) -> StateDict:
    """The first (transformers-named) text encoder's state dict under
    ``conditioner.embedders.0.transformer.``."""
    return {"conditioner.embedders.0.transformer." + k: v.contiguous()
            for k, v in state.items()}


def synth_openclip(state: Mapping[str, torch.Tensor]) -> StateDict:
    """The second text encoder's state dict -> OpenCLIP keys under
    ``conditioner.embedders.1.model.``: q/k/v fused into ``in_proj``,
    ``text_projection`` as the ``x @ W`` parameter, and a zero
    ``logit_scale``."""
    prefix = "conditioner.embedders.1.model."
    out: StateDict = {}
    qkv: Dict[tuple, Dict[str, torch.Tensor]] = {}
    like = None
    for key, value in state.items():
        like = value
        if key == "text_projection.weight":
            out[prefix + "text_projection"] = value.t().contiguous()
            continue
        if key.startswith("text_model.embeddings."):
            name = {"token_embedding": "token_embedding.weight",
                    "position_embedding": "positional_embedding"}[
                        key.split(".")[2]]
            out[prefix + name] = value.contiguous()
            continue
        if key.startswith("text_model.final_layer_norm."):
            out[prefix + "ln_final." + key.split(".")[-1]] = value.contiguous()
            continue
        m = re.match(r"^text_model\.encoder\.layers\.(\d+)\.(.*)\.(weight|bias)$",
                     key)
        layer, module, kind = m[1], m[2], m[3]
        if module in ("self_attn.q_proj", "self_attn.k_proj",
                      "self_attn.v_proj"):
            qkv.setdefault((layer, kind), {})[module.split(".")[1][0]] = value
            continue
        out[f"{prefix}transformer.resblocks.{layer}."
            f"{_OPENCLIP_LAYER[module]}.{kind}"] = value.contiguous()
    for (layer, kind), parts in qkv.items():
        out[f"{prefix}transformer.resblocks.{layer}.attn.in_proj_{kind}"] = \
            torch.cat([parts["q"], parts["k"], parts["v"]], dim=0)
    out[prefix + "logit_scale"] = torch.zeros((), dtype=like.dtype,
                                              device=like.device)
    return out


def synth_single_file(bundle) -> StateDict:
    """A full SGM single-file state dict of a port ``ModelBundle`` (sdxl
    family: UNet, VAE, both text encoders)."""
    cfg = bundle.config
    state = synth_sgm_unet(bundle.unet.state_dict(), cfg.unet.layers_per_block)
    state.update(synth_ldm_vae(bundle.vae.state_dict(),
                               len(cfg.vae.block_out_channels)))
    state.update(synth_hf_clip(bundle.text_encoder.state_dict()))
    if bundle.text_encoder_2 is not None:
        state.update(synth_openclip(bundle.text_encoder_2.state_dict()))
    return state
