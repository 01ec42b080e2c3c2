"""JAX parameter trees -> the port's state dicts.

The inverse of ``cfgpp_tpu/weights/convert.py`` (diffusers / transformers
state dicts -> Flax trees): flattened Flax names go back to dotted diffusers
names, and tensors back to torch conventions.

  kernel [kh,kw,I,O] (HWIO)  -> weight [O,I,kh,kw] (OIHW)
  kernel [I,O]               -> weight [O,I]
  scale                      -> weight (norms)
  embedding                  -> weight
  down_blocks_0_attentions_0 -> down_blocks.0.attentions.0
  ff/net_0_proj, to_out      -> ff.net.0.proj, to_out.0

Quantized trees (``cfgpp_tpu``'s ``ModelBundle.quantized(mode).params()``):
a module whose ``kernel`` is int8 is a W8A8 layer, and its ``scale`` is a
per-output-channel weight scale, not a norm weight:

  int8 kernel [K,N]          -> int8 weight [N,K]
  int8 kernel [1,1,I,O]      -> int8 weight [O,I] (1x1 conv)
  int8 kernel [3,3,I,O]      -> int8 weight [O,3,3,I] (3x3 conv)
  scale [N]                  -> weight_scale [N], f32
  bias [N]                   -> bias [N], f32
  attn1/to_qkv               -> attn1.to_qkv

Input trees hold array-likes (numpy or JAX arrays, read through
``np.asarray``); nothing here imports JAX.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_name(part: str) -> str:
    """One flattened Flax module name -> its dotted diffusers path."""
    if part == "to_out":
        return "to_out.0"
    if part in ("linear_1", "linear_2"):       # real names ending in a digit
        return part
    part = re.sub(r"^mid_block_", "mid_block.", part)
    return re.sub(r"_(\d+)(_|$)",
                  lambda m: f".{m[1]}" + ("." if m[2] else ""), part)


def _tensor(kind: str, value) -> Tuple[str, torch.Tensor]:
    arr = np.asarray(value, dtype=np.float32)
    if kind == "kernel":
        arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        return "weight", torch.from_numpy(np.ascontiguousarray(arr))
    if kind in ("scale", "embedding"):
        return "weight", torch.from_numpy(arr.copy())
    if kind == "bias":
        return "bias", torch.from_numpy(arr.copy())
    raise KeyError(f"unhandled parameter kind {kind!r}")


def _int8_tensor(kind: str, value) -> Tuple[str, torch.Tensor]:
    arr = np.asarray(value)
    if kind == "kernel":
        if arr.ndim == 4 and arr.shape[:2] == (1, 1):
            arr = arr[0, 0]
        elif arr.ndim == 4 and arr.shape[:2] != (3, 3):
            raise ValueError(f"int8 conv kernel {arr.shape}: the port's int8 "
                             "convs are 1x1 or 3x3")
        arr = arr.transpose(3, 0, 1, 2) if arr.ndim == 4 else arr.T
        return "weight", torch.from_numpy(np.ascontiguousarray(arr))
    if kind == "scale":
        return "weight_scale", torch.from_numpy(arr.astype(np.float32))
    if kind == "bias":
        return "bias", torch.from_numpy(arr.astype(np.float32))
    raise KeyError(f"unhandled parameter kind {kind!r} of an int8 layer")


def diffusers_state_dict(params: Mapping) -> StateDict:
    """JAX UNet2DConditionModel (exact or quantized) or AutoencoderKL params
    -> the diffusers state dict of the same model."""
    tree = params.get("params", params)
    leaves = list(_leaves(tree))
    int8_layers = {path[:-1] for path, value in leaves
                   if path[-1] == "kernel" and np.asarray(value).dtype == np.int8}
    out: StateDict = {}
    for path, value in leaves:
        convert = _int8_tensor if path[:-1] in int8_layers else _tensor
        kind, value = convert(path[-1], value)
        out[".".join([_module_name(p) for p in path[:-1]] + [kind])] = value
    return out


def clip_text_state_dict(params: Mapping) -> StateDict:
    """JAX CLIPTextModel params -> transformers CLIPTextModel state dict."""
    tree = params.get("params", params)
    out: StateDict = {}
    for path, value in _leaves(tree):
        top = path[0]
        if top == "token_embedding":
            out["text_model.embeddings.token_embedding.weight"] = _tensor(
                "embedding", value)[1]
        elif top == "position_embedding":
            out["text_model.embeddings.position_embedding.weight"] = _tensor(
                "embedding", value)[1]
        elif top == "text_projection":
            out["text_projection.weight"] = _tensor("kernel", value)[1]
        else:
            kind, t = _tensor(path[-1], value)
            mods = [_module_name(p) for p in path[:-1]]
            where = ("text_model.encoder." if top.startswith("layers_")
                     else "text_model.")
            out[where + ".".join(mods + [kind])] = t
    return out
