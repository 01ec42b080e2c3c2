"""CLIP-score: prompt <-> generated-image cosine similarity, counterpart of
``cfgpp_tpu/metrics/clip_score.py``.

The standard CLIPScore (Hessel et al. 2021 / torchmetrics):

    score = mean_i  100 * max(0, cos(E_text(prompt_i), E_img(image_i)))

using the OpenAI CLIP ViT-L/14 text and vision towers (`models/clip.py`,
`models/clip_vision.py`) — one checkpoint, both projections.  The towers
run in f32 on ``device``; features are L2-normalized on the host.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from cfgpp_tpu_torch.utils.img import AsyncImageReader, resize


@functools.lru_cache(maxsize=1)
def _load_state(path: str):
    """One checkpoint load per process: the CLI touches the CLIP weights
    for CLIP-FID, CLIP-score images AND text (shared loader with the
    Inception tower)."""
    from cfgpp_tpu_torch.metrics.inception import _load_state_dict
    return _load_state_dict(path)


@torch.no_grad()
def clip_text_features(prompts: Sequence[str], clip_ckpt: str,
                       tokenizer_dir: Optional[str] = None,
                       batch: int = 256, device: str = "cuda") -> np.ndarray:
    """Prompts -> [N, projection_dim] L2-normalized text embeddings.

    Requires a REAL CLIP tokenizer (``tokenizer_dir`` or
    $CFGPP_TOKENIZER_DIR with vocab.json + merges.txt): with real weights,
    the hash-fallback tokenizer would produce numerically plausible but
    meaningless scores, so it is rejected here."""
    from cfgpp_tpu_torch.configs import CLIPTextConfig
    from cfgpp_tpu_torch.models.clip import CLIPTextModel
    from cfgpp_tpu_torch.weights.convert import clip_text_from_hf, load_module_
    from cfgpp_tpu_torch.weights.tokenizer import HashTokenizer, load_tokenizer

    state = _load_state(clip_ckpt)
    cfg = CLIPTextConfig(projection_dim=768)
    tok = load_tokenizer(tokenizer_dir, vocab_size=cfg.vocab_size,
                         eos_token_id=cfg.eos_token_id)
    if isinstance(tok, HashTokenizer):
        raise ValueError(
            "CLIP-score needs the real CLIP BPE tokenizer: pass "
            "tokenizer_dir (or set $CFGPP_TOKENIZER_DIR) pointing at "
            "vocab.json + merges.txt.  Refusing the hash-fallback "
            "tokenizer, which would silently produce meaningless scores "
            "against real checkpoint weights.")
    model = CLIPTextModel(cfg).to(device).eval()
    load_module_(model, clip_text_from_hf(state), "clip text")
    feats = []
    for i in range(0, len(prompts), batch):
        ids = torch.from_numpy(tok(list(prompts[i:i + batch]))).long()
        feats.append(model(ids.to(device)).pooled_output.cpu().numpy())
    out = np.concatenate(feats)
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


@functools.lru_cache(maxsize=2)
def _cached_vision_extractor(clip_ckpt: str, device: str):
    """Load + convert the CLIP vision tower once per checkpoint and device:
    a CLIP-FID run extracts features for BOTH directories."""
    from cfgpp_tpu_torch.models.clip_vision import (CLIPVisionConfig,
                                                    CLIPVisionModel)
    from cfgpp_tpu_torch.weights.convert import (clip_vision_from_hf,
                                                 load_module_)

    model = CLIPVisionModel(CLIPVisionConfig()).to(device).eval()
    load_module_(model, clip_vision_from_hf(_load_state(clip_ckpt)),
                 "clip vision")
    return model


def load224(px: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 -> [224, 224, 3] float32 in [0, 1] as the CLIP
    processor prepares it: the SHORTEST side resized to 224 (PIL bicubic;
    the other side rounded as torchvision's Resize rounds it, half to even,
    and at least 224), then the center 224x224 crop (offsets rounded
    down)."""
    h, w = px.shape[:2]
    if (w, h) != (224, 224):
        scale = 224.0 / min(w, h)
        nw, nh = (224, max(224, round(h * scale))) if w <= h else \
            (max(224, round(w * scale)), 224)
        px = resize(px, (nw, nh), "bicubic")
        left = (nw - 224) // 2
        top = (nh - 224) // 2
        px = px[top:top + 224, left:left + 224]
    return px.astype(np.float32) / 255.0


@torch.no_grad()
def clip_image_features(paths: Sequence[str], clip_ckpt: str,
                        batch: int = 64, device: str = "cuda") -> np.ndarray:
    """Image files -> [N, projection_dim] L2-normalized image embeddings.

    Preprocessing matches the CLIP processor exactly (`load224`), so
    scores on non-square inputs (raw MS-COCO references) are comparable
    to torchmetrics / clean-fid numbers.  Features are L2-normalized here;
    CLIP-FID consumers therefore get normalized embeddings (the clean-fid
    convention), which shifts clip_fid scale vs unnormalized variants.
    Files decode and crop in the `AsyncImageReader`'s workers.
    """
    from cfgpp_tpu_torch.models.clip_vision import preprocess_for_clip

    model = _cached_vision_extractor(str(clip_ckpt), str(torch.device(device)))
    paths = [str(p) for p in paths]
    feats = []
    with AsyncImageReader(paths, transform=load224) as reader:
        for i in range(0, len(paths), batch):
            imgs = np.stack([reader.get(k)
                             for k in range(i, min(i + batch, len(paths)))])
            x = preprocess_for_clip(torch.from_numpy(imgs).to(device))
            feats.append(model(x).cpu().numpy())
    out = np.concatenate(feats)
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def clip_score_from_features(text_feats: np.ndarray,
                             image_feats: np.ndarray) -> float:
    """Paired, already-normalized features -> mean 100*max(0, cos)."""
    if text_feats.shape != image_feats.shape:
        raise ValueError(
            f"feature shapes differ: {text_feats.shape} vs {image_feats.shape}")
    cos = np.sum(text_feats * image_feats, axis=-1)
    return float(np.mean(100.0 * np.clip(cos, 0.0, None)))


def clip_score(prompts: Sequence[str], image_paths: Sequence[str],
               clip_ckpt: str, tokenizer_dir: Optional[str] = None,
               device: str = "cuda") -> float:
    if len(prompts) != len(image_paths):
        raise ValueError(
            f"{len(prompts)} prompts vs {len(image_paths)} images")
    t = clip_text_features(prompts, clip_ckpt, tokenizer_dir=tokenizer_dir,
                           device=device)
    v = clip_image_features(image_paths, clip_ckpt, device=device)
    return clip_score_from_features(t, v)
