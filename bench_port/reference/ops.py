"""The products of the plain reference, in float32 or in the control's fp8.

Every matrix product and convolution of the reference models goes through
an `Ops`: `F32` computes in float32 (TF32 is turned off by `no_tf32`, so
cuBLAS and cuDNN keep full float32 products); `Ops(fp8=True)` is the
control of a bfloat16 cell, the same arithmetic with both operands of every
product rounded to float8 e4m3 under one scale per tensor (amax / 448), the
sums still in float32.

A layer marked ``quant`` (the W8A8 sites of an int8 cell) goes through
`Ops.quantized_linear`: the program's recipe, symmetric per-output-channel
weights (amax / 127 of each row of the weight) and symmetric dynamic
activations per row (x times 1 / (amax / 127)), rounded to nearest and
clamped to +-127, the integer product in float32, then the two scales and
the bias.  ``Ops(int_bits=4)`` is its control: the same with +-7 levels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Ops:
    def __init__(self, fp8: bool = False, int_bits: int = 8):
        self.fp8 = fp8
        self.levels = 2.0 ** (int_bits - 1) - 1

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def linear(self, x, w, b=None):
        return F.linear(self.round(x), self.round(w), b)

    def conv2d(self, x, w, b, stride, padding):
        return F.conv2d(self.round(x), self.round(w), b, stride, padding)

    def matmul(self, a, b):
        return self.round(a) @ self.round(b)

    def quantized_linear(self, x, w, b=None):
        n = self.levels
        sw = w.abs().amax(dim=1).clamp_min(1e-8) / n
        wq = torch.clamp(torch.round(w / sw[:, None]), -n, n)
        sx = x.abs().amax(-1, keepdim=True).clamp_min(1e-6) * (1.0 / n)
        xq = torch.clamp(torch.round(x * (1.0 / sx)), -n, n)
        y = F.linear(xq, wq) * sx * sw
        return y if b is None else y + b


F32 = Ops()
