"""FID InceptionV3 (pool3, 2048-d features), counterpart of
``cfgpp_tpu/metrics/inception.py``.

The standard FID metric (reference: `utils/calculate_metrics.py:167-182`,
which shells out to `pytorch_fid.calculate_fid_given_paths`) is defined
against a specific InceptionV3 port of the 2015-12-05 TF graph.  This module
implements that FID variant exactly, with the JAX module's quirks:

* InceptionA/C and Mixed_7b pool branches use 3x3 s1 average pooling with
  ``count_include_pad=False`` (pytorch-fid's FIDInceptionA/C/E_1 overrides);
* Mixed_7c (FIDInceptionE_2) uses a 3x3 s1 SAME **max** pool branch;
  the other max pools are VALID 3x3 stride 2;
* the 1x7 / 7x1 convs pad (0, 3) / (3, 0); branches concatenate in the
  JAX module's order; the features are the mean over H and W;
* inputs are bilinearly resized to 299x299 (half-pixel centers, no
  antialias: ``F.interpolate(..., mode='bilinear')``) and mapped to
  [-1, 1].

BatchNorm (eps=1e-3) is folded into the conv weights at conversion time
(`convert_inception`), so inference is conv + bias + relu, in f32 and NCHW
inside (the module takes NHWC images, as the JAX one does).  Weights load
from a pytorch-fid / torchvision-layout state dict
(``Mixed_5b.branch1x1.conv.weight`` etc., e.g. the published
``pt_inception-2015-12-05-6726825d.pth``), as ``.pth`` or ``.safetensors``.
"""

from __future__ import annotations

import functools
import logging
from typing import Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cfgpp_tpu_torch.models.attention import Conv2d
from cfgpp_tpu_torch.utils.img import AsyncImageReader, image_size, resize


def _avg_pool_3x3_no_pad_count(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME avg-pool with count_include_pad=False."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class BasicConv2d(nn.Module):
    """conv (BN pre-folded, so with a bias) + relu."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride=stride, padding=padding)

    def forward(self, x):
        return F.relu(self.conv(x))


_P17, _P71 = (0, 3), (3, 0)           # 1x7 and 7x1 paddings


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_no_pad_count(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=_P17)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=_P71)
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=_P71)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=_P17)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=_P71)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=_P17)
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_3x3_no_pad_count(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=_P17)
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=_P71)
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    """Mixed_7b pools by average (count_include_pad=False), Mixed_7c by max
    (pytorch-fid FIDInceptionE_1 vs FIDInceptionE_2)."""

    def __init__(self, cin: int, pool_mode: str):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        if self.pool_mode == "avg":
            bp = _avg_pool_3x3_no_pad_count(x)
        else:
            bp = F.max_pool2d(x, 3, 1, 1)
        bp = self.branch_pool(bp)
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3Features(nn.Module):
    """[N, H, W, 3] in [0, 1] -> [N, 2048] pool3 features (FID standard)."""

    def __init__(self, resize_input: bool = True, normalize_input: bool = True):
        super().__init__()
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        if self.resize_input:
            x = F.interpolate(x, size=(299, 299), mode="bilinear",
                              align_corners=False, antialias=False)
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))             # adaptive avg pool -> 2048


def fold_batchnorm(conv_w, bn_gamma, bn_beta, bn_mean, bn_var,
                   eps: float = 1e-3):
    """torch conv weight [O,I,kh,kw] + BN stats -> (weight [O,I,kh,kw],
    bias [O]), f32."""
    f32 = lambda t: torch.as_tensor(t, dtype=torch.float32)  # noqa: E731
    inv = f32(bn_gamma) / torch.sqrt(f32(bn_var) + eps)
    weight = f32(conv_w) * inv[:, None, None, None]
    bias = f32(bn_beta) - f32(bn_mean) * inv
    return weight, bias


def convert_inception(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """pytorch-fid / torchvision inception state dict -> the
    `InceptionV3Features` state dict.

    Expects keys ``<block>.<branch>.conv.weight`` + ``<block>.<branch>.bn.*``
    (aux-classifier and fc keys are ignored).
    """
    out: Dict[str, torch.Tensor] = {}
    prefixes = sorted({k.rsplit(".conv.weight", 1)[0]
                       for k in state if k.endswith(".conv.weight")})
    for pre in prefixes:
        if pre.startswith(("AuxLogits", "fc")):
            continue
        out[f"{pre}.conv.weight"], out[f"{pre}.conv.bias"] = fold_batchnorm(
            state[f"{pre}.conv.weight"],
            state[f"{pre}.bn.weight"], state[f"{pre}.bn.bias"],
            state[f"{pre}.bn.running_mean"], state[f"{pre}.bn.running_var"])
    return out


def _load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file (the port's own reader) or a ``.pth`` one
    (``torch.load``, tensors only; a saved module is unwrapped by its
    ``state_dict()``), on the CPU."""
    if path.endswith(".safetensors"):
        from cfgpp_tpu_torch.weights.safetensors_io import load_file
        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return dict(sd)


@functools.lru_cache(maxsize=2)
def _cached_extractor(ckpt_path: str, device: str) -> InceptionV3Features:
    """Load + convert once per checkpoint path and device: a FID run calls
    the extractor for BOTH directories and would otherwise pay two weight
    loads."""
    from cfgpp_tpu_torch.weights.convert import load_module_
    model = InceptionV3Features().to(device).eval()
    load_module_(model, convert_inception(_load_state_dict(ckpt_path)),
                 "inception")
    return model


def _to_299(px: np.ndarray) -> np.ndarray:
    """The mixed-size path's host resize: PIL bilinear to 299x299."""
    return px if px.shape[:2] == (299, 299) else resize(px, (299, 299),
                                                        "bilinear")


def _uniform_size(paths: Sequence[str]) -> bool:
    """Whether every image has one size, from the headers; stops at the
    second distinct size."""
    sizes = set()
    for p in paths:
        sizes.add(image_size(p))
        if len(sizes) > 1:
            return False
    return True


@torch.no_grad()
def inception_features(paths, ckpt_path: str, batch: int = 50,
                       device: str = "cuda") -> np.ndarray:
    """Image files -> [N, 2048] FID features (weights from a .pth/.safetensors
    pytorch-fid state dict).

    Uniform-size directories go through the model's own bilinear resize
    (bit-parity with pytorch-fid's F.interpolate).  Heterogeneous
    directories (e.g. raw MS-COCO references — which crash pytorch-fid's
    own batched loader) are host-resized per image to 299 with PIL
    bilinear first; the kernel difference is logged since resize choice
    can shift FID slightly.  Files decode (and resize) in the
    `AsyncImageReader`'s workers."""
    if not paths:
        raise ValueError("inception_features: no images given (empty or "
                         "unmatched directory?)")
    model = _cached_extractor(str(ckpt_path), str(torch.device(device)))
    paths = [str(p) for p in paths]
    uniform = _uniform_size(paths)
    if not uniform:
        logging.getLogger("cfgpp_tpu.metrics").warning(
            "mixed image sizes in FID input: host PIL-bilinear resize to "
            "299 replaces the in-model tensor resize for this directory "
            "(pytorch-fid's own loader cannot batch mixed sizes)")

    feats = []
    with AsyncImageReader(paths, transform=None if uniform else _to_299) \
            as reader:
        for i in range(0, len(paths), batch):
            imgs = np.stack([reader.get(k)
                             for k in range(i, min(i + batch, len(paths)))])
            x = torch.from_numpy(imgs).to(device).float() / 255.0
            feats.append(model(x).cpu().numpy())
    return np.concatenate(feats)
