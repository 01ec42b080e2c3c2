"""Seeded random weights for the metric towers, in the published layouts.

The real files (pytorch-fid's ``pt_inception-2015-12-05`` state dict,
torchvision's VGG16, the LPIPS linear heads, OpenAI CLIP ViT-L/14 and its
BPE vocabulary) are not in the repository.  These functions make state
dicts with the same names, shapes and dtypes from a seed, so that the
loaders the real files go through (``cfgpp_tpu_torch.metrics`` and
``cfgpp_tpu/metrics``) can be driven at full width:

* `inception_state`: pytorch-fid's FIDInceptionV3 keys
  (``<block>.<branch>.conv.weight``, ``.bn.{weight,bias,running_mean,
  running_var,num_batches_tracked}``, and the unused ``fc``): He-scaled
  conv weights and BN scales near 1, so that the features of two images
  differ after 94 layers (FID of random features is then well above its
  rounding), BN shifts and running means N(0, 0.05^2), running variances
  in [0.5, 1.5) (kept positive, as ``tests/test_inception.py`` makes
  them);
* `vgg16_state`: torchvision ``vgg16.features.{0,2,5,...,28}`` (He-scaled,
  so that 13 layers neither vanish nor blow up; the classifier, which LPIPS
  never reads, is left out);
* `lpips_heads_state`: ``lin{i}.model.1.weight`` [1, C, 1, 1], nonnegative;
* `clip_model_state`: a combined transformers ``CLIPModel`` (text and
  vision towers, both projections, ``logit_scale`` and the int64
  ``position_ids`` buffers of older files): linear and patch-conv weights
  N(0, 1/fan_in) (so that attention is far from uniform and the class
  token depends on the image), embeddings and biases N(0, 0.02^2), layer
  norms near 1; the two projections share one direction (`_share_direction`),
  so that a prompt's and an image's features have a positive cosine (about
  0.2) and CLIP-score is not clamped to 0;
* `write_clip_vocab`: ``vocab.json`` and ``merges.txt`` in the real files'
  layout: the byte alphabet and its ``</w>`` forms, a few merges, and
  ``<|startoftext|>`` / ``<|endoftext|>`` at 49406 / 49407 as in the real
  vocabulary.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import torch

from cfgpp_tpu_torch.configs import CLIPTextConfig
from cfgpp_tpu_torch.metrics.inception import InceptionV3Features
from cfgpp_tpu_torch.models.clip import CLIPTextModel
from cfgpp_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel
from cfgpp_tpu_torch.weights.tokenizer import _bytes_to_unicode

StateDict = Dict[str, torch.Tensor]
_VGG_CONV_POSITIONS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
_LPIPS_CHANNELS = (64, 128, 256, 512, 512)
_MERGES = (("t", "h"), ("th", "e</w>"), ("a", "n"), ("o", "n</w>"),
           ("i", "n"), ("e", "r"), ("a", "</w>"))
BOS_ID, EOS_ID = 49406, 49407
# The norm of the shared component of a projected feature (`_share_direction`)
# against about sqrt(projection_dim), 27.7 at 768, for the random one.
_SHARED_NORM = 14.0


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def inception_state(seed: int = 0) -> StateDict:
    g = _gen(seed)
    with torch.device("meta"):
        shapes = {k[:-len(".conv.weight")]: v.shape
                  for k, v in InceptionV3Features().state_dict().items()
                  if k.endswith(".conv.weight")}
    out: StateDict = {}
    for pre, shape in shapes.items():
        o, fan_in = shape[0], shape[1] * shape[2] * shape[3]
        out[f"{pre}.conv.weight"] = torch.randn(
            shape, generator=g) * (2.0 / fan_in) ** 0.5
        out[f"{pre}.bn.weight"] = 1.0 + torch.randn(o, generator=g) * 0.1
        out[f"{pre}.bn.bias"] = torch.randn(o, generator=g) * 0.05
        out[f"{pre}.bn.running_mean"] = torch.randn(o, generator=g) * 0.05
        out[f"{pre}.bn.running_var"] = torch.rand(o, generator=g) + 0.5
        out[f"{pre}.bn.num_batches_tracked"] = torch.tensor(0)
    out["fc.weight"] = torch.randn(1008, 2048, generator=g) * 0.01
    out["fc.bias"] = torch.zeros(1008)
    return out


def vgg16_state(seed: int = 0) -> StateDict:
    g = _gen(seed)
    out: StateDict = {}
    cin = 3
    for pos, cout in zip(_VGG_CONV_POSITIONS, _VGG_CHANNELS):
        out[f"features.{pos}.weight"] = torch.randn(
            cout, cin, 3, 3, generator=g) * (2.0 / (9 * cin)) ** 0.5
        out[f"features.{pos}.bias"] = torch.randn(cout, generator=g) * 0.01
        cin = cout
    return out


def lpips_heads_state(seed: int = 0) -> StateDict:
    g = _gen(seed)
    return {f"lin{i}.model.1.weight":
            torch.randn(1, c, 1, 1, generator=g).abs() * 0.1
            for i, c in enumerate(_LPIPS_CHANNELS)}


def _random_like(names_shapes, g: torch.Generator) -> StateDict:
    out: StateDict = {}
    for name, shape in names_shapes:
        module = name.rsplit(".", 2)[-2]
        if "norm" in module and name.endswith(".weight"):
            out[name] = 1.0 + 0.02 * torch.randn(shape, generator=g)
        elif name.endswith(".weight") and len(shape) >= 2 \
                and not module.endswith("_embedding") or module == "patch_embedding":
            fan_in = shape[1:].numel()
            out[name] = torch.randn(shape, generator=g) / fan_in ** 0.5
        else:
            out[name] = 0.02 * torch.randn(shape, generator=g)
    return out


def _share_direction(out: StateDict, g: torch.Generator) -> None:
    """Give the text and image features one common direction ``d``.  Each
    tower's last layer norm gets a bias of 1 on every channel; its
    projection's rows are centred (so that this bias projects to nothing
    of their own) and gain ``_SHARED_NORM / width`` times ``d``.  A
    layer norm's normalized part has mean 0, so the projected features are
    ``_SHARED_NORM * d`` plus the random projection of what the tower
    computed, and a text-image cosine is about
    ``_SHARED_NORM^2 / (_SHARED_NORM^2 + projection_dim)``."""
    d = torch.randn(out["visual_projection.weight"].shape[0], generator=g)
    d = d / d.norm()
    for norm, proj in (("text_model.final_layer_norm.bias", "text_projection.weight"),
                       ("vision_model.post_layernorm.bias", "visual_projection.weight")):
        w = out[proj]
        out[norm] = out[norm] + 1.0
        out[proj] = (w - w.mean(1, keepdim=True)
                     + _SHARED_NORM / w.shape[1] * d[:, None])


def clip_model_state(seed: int = 0,
                     text_cfg: Optional[CLIPTextConfig] = None,
                     vision_cfg: Optional[CLIPVisionConfig] = None) -> StateDict:
    """A combined transformers CLIPModel state dict (ViT-L/14 by default:
    the 12-layer 768-wide text tower with its 768-d projection, the
    24-layer 1024-wide image tower with its 768-d projection)."""
    text_cfg = text_cfg or CLIPTextConfig(projection_dim=768)
    vision_cfg = vision_cfg or CLIPVisionConfig()
    g = _gen(seed)
    with torch.device("meta"):
        text = CLIPTextModel(text_cfg).state_dict()
        vision = CLIPVisionModel(vision_cfg).state_dict()
    out = _random_like(((k, v.shape) for k, v in text.items()), g)
    out.update(_random_like(((k, v.shape) for k, v in vision.items()), g))
    _share_direction(out, g)
    n_pos = (vision_cfg.image_size // vision_cfg.patch_size) ** 2 + 1
    out["text_model.embeddings.position_ids"] = torch.arange(
        text_cfg.max_position_embeddings)[None]
    out["vision_model.embeddings.position_ids"] = torch.arange(n_pos)[None]
    out["logit_scale"] = torch.tensor(4.6052)
    return out


def write_clip_vocab(directory) -> Path:
    """``vocab.json`` + ``merges.txt`` under ``directory``; returns it."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    chars = list(_bytes_to_unicode().values())
    vocab = chars + [c + "</w>" for c in chars] + ["".join(m) for m in _MERGES]
    ids = {tok: i for i, tok in enumerate(vocab)}
    ids["<|startoftext|>"] = BOS_ID
    ids["<|endoftext|>"] = EOS_ID
    (d / "vocab.json").write_text(json.dumps(ids))
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in _MERGES) + "\n")
    return d
