"""The addressing of the int8 conv's implicit GEMM, on the CPU.

`int8_conv3x3`'s kernel quantizes each scale window once into a buffer
``xq [B*H/br, br+2, W, C]`` and runs the conv as a GEMM with M = B*H*W
output pixels, N = O and K = 9*C in tap-major order, gathering each A row
from the window buffer (``csrc/int8_conv.cu:conv_s8``).
`conv_gemm_operands_reference` builds those operands with the kernel's
addresses; here ``A @ B.T`` (f64, exact) must equal the int32 sums of the
plain conv (`window_sums_reference`) at every output pixel, at the four
SD-1.5 sites of ``--quant all`` (batch 2, channels narrowed) and at edge
shapes: one-row windows, tiles that straddle windows, C and O that are no
multiple of the kernel's 64-wide k step or tiles.  The epilogue's row scale
(window ``row // W // br`` of each pixel) then gives `window_conv_reference`
bit for bit.
"""

import numpy as np
import pytest
import torch

from cfgpp_tpu_torch.kernels import int8_conv as tc

# (case, batch, H, W, C, O, br): the SD-1.5 sites' H, W and br (up_blocks.1
# upsampler, up_blocks.2 resnets.0 conv1, resnets.1 conv1, up_blocks.2
# upsampler) with narrowed channels, then edge shapes.
CASES = [
    ("up_blocks.1 upsampler", 2, 32, 32, 32, 32, 16),
    ("up_blocks.2 resnets.0 conv1", 2, 32, 32, 48, 16, 8),
    ("up_blocks.2 resnets.1 conv1", 2, 32, 32, 32, 16, 16),
    ("up_blocks.2 upsampler", 2, 64, 64, 16, 16, 8),
    ("br 1, C 48, O 40", 1, 8, 32, 48, 40, 1),
    ("tiles straddle windows", 2, 8, 32, 16, 24, 2),
    ("W 48, C 80", 1, 6, 48, 80, 8, 3),
]
IDS = [c[0] for c in CASES]


def _windows(batch, h, w, c, br, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch, h, w, c)).astype(np.float32))
    gs = torch.from_numpy(rng.normal(1, 0.2, (batch, c)).astype(np.float32))
    gb = torch.from_numpy(rng.normal(0, 0.3, (batch, c)).astype(np.float32))
    return tc.conv_windows_reference(tc.conv_prologue_reference(x, gs, gb), br)


def _weights(o, c, seed):
    rng = np.random.default_rng(seed + 1)
    return torch.from_numpy(rng.integers(-127, 128, (o, 3, 3, c)).astype(np.int8))


@pytest.mark.parametrize("case,batch,h,w,c,o,br", CASES, ids=IDS)
def test_gemm_operands_give_the_conv_sums(case, batch, h, w, c, o, br):
    xq, _ = _windows(batch, h, w, c, br, h * w + c)
    wq = _weights(o, c, c + o)
    a, b = tc.conv_gemm_operands_reference(xq, wq)
    m = batch * h * w
    assert a.shape == (m, 9 * c) and b.shape == (o, 9 * c)
    want = tc.window_sums_reference(xq, wq).reshape(m, o)
    got = a.double() @ b.double().t()
    assert torch.equal(got, want)
    assert (want.abs() < 2 ** 31).all()      # int32 sums, as on the card
    if case == "tiles straddle windows":     # a 128-pixel tile, 2-row windows
        win = torch.arange(m) // w // br
        assert (win[:128].unique().numel() > 1)


@pytest.mark.parametrize("case,batch,h,w,c,o,br", CASES[:2] + CASES[4:5],
                         ids=IDS[:2] + IDS[4:5])
def test_gemm_rows_scaled_by_their_window(case, batch, h, w, c, o, br):
    """The epilogue from the GEMM: each output pixel's row scaled by the
    scale of window ``row // W // br``, ``(acc*sx)*w_scale + bias``."""
    xq, sx = _windows(batch, h, w, c, br, 7 * h + c)
    wq = _weights(o, c, 3 * c)
    ws = torch.from_numpy(np.random.default_rng(o).uniform(
        1e-3, 1e-2, o).astype(np.float32))
    bias = torch.linspace(-0.5, 0.5, o)
    a, b = tc.conv_gemm_operands_reference(xq, wq)
    acc = (a.double() @ b.double().t()).float()
    row_sx = sx[torch.arange(batch * h * w) // w // br]
    got = (acc * row_sx[:, None] * ws + bias).reshape(batch, h, w, o)
    want = tc.window_conv_reference(xq, sx, wq, ws, bias, None, batch)
    assert torch.equal(got, want)
