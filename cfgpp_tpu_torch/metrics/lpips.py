"""LPIPS (VGG flavour), counterpart of ``cfgpp_tpu/metrics/lpips.py``.

Perceptual distance used by the reference's metric CLI
(`utils/calculate_metrics.py:144-151`, lpips package, net='vgg').  The VGG16
feature trunk + per-layer 1x1 linear heads are implemented here; weights
convert from a torchvision-format VGG16 state dict plus LPIPS linear-head
tensors via `convert_vgg16_lpips`.  As in the JAX module: the scaling
layer's shift and scale, 2x2 max pools after stages 0-3 only, each tap
divided by ``norm + 1e-10`` over its channels (the epsilon outside the
square root), 1x1 heads without bias, and the mean over (H, W, 1).  The
module takes NHWC images in [-1, 1] and runs NCHW inside, in f32.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from cfgpp_tpu_torch.models.attention import Conv2d

# VGG16 conv plan: (out_channels, n_convs) per stage; taps after each stage.
_VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# channels of the tapped activations, in order
LPIPS_TAP_CHANNELS = tuple(c for c, _ in _VGG_STAGES)
# torchvision `vgg16.features` indices of the conv layers, in order
_VGG_CONV_POSITIONS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)

# ImageNet normalization LPIPS uses (its 'scaling layer').
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """VGG16 trunk returning the 5 LPIPS tap activations (NCHW)."""

    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for ch, n in _VGG_STAGES:
            for _ in range(n):
                setattr(self, f"conv_{i}", Conv2d(cin, ch, 3, padding=1))
                cin, i = ch, i + 1

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps, i = [], 0
        for stage, (_, n) in enumerate(_VGG_STAGES):
            for _ in range(n):
                x = F.relu(getattr(self, f"conv_{i}")(x))
                i += 1
            taps.append(x)
            if stage < len(_VGG_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return taps


class LPIPS(nn.Module):
    """lpips(img0, img1) for NHWC images in [-1, 1] -> [B]."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, c in enumerate(LPIPS_TAP_CHANNELS):
            setattr(self, f"lin_{i}", Conv2d(c, 1, 1, bias=False))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        shift = torch.tensor(_SHIFT, dtype=a.dtype, device=a.device)
        scale = torch.tensor(_SCALE, dtype=a.dtype, device=a.device)

        def norm_input(x):
            return ((x - shift) / scale).permute(0, 3, 1, 2)

        fa, fb = self.vgg(norm_input(a)), self.vgg(norm_input(b))
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            xa = xa / (torch.linalg.vector_norm(xa, dim=1, keepdim=True) + 1e-10)
            xb = xb / (torch.linalg.vector_norm(xb, dim=1, keepdim=True) + 1e-10)
            w = getattr(self, f"lin_{i}")((xa - xb) ** 2)
            total = total + w.mean(dim=(1, 2, 3))
        return total


def convert_vgg16_lpips(vgg_state: Mapping[str, torch.Tensor],
                        lin_state: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """torchvision `vgg16.features` + LPIPS `lin{i}.model.1.weight` tensors
    -> the `LPIPS` state dict."""
    out: Dict[str, torch.Tensor] = {}
    for i, pos in enumerate(_VGG_CONV_POSITIONS):
        out[f"vgg.conv_{i}.weight"] = vgg_state[f"features.{pos}.weight"]
        out[f"vgg.conv_{i}.bias"] = vgg_state[f"features.{pos}.bias"]
    for i in range(len(LPIPS_TAP_CHANNELS)):
        out[f"lin_{i}.weight"] = lin_state[f"lin{i}.model.1.weight"]  # [1,C,1,1]
    return out
