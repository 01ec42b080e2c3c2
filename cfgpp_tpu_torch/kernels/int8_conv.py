"""W8A8 3x3 convolution (stride 1, zero pad 1, NHWC) with in-kernel
activation quantization per (sample, window of rows).

`int8_conv3x3` is the counterpart of ``cfgpp_tpu/kernels/int8_conv.py``'s
function of the same name.  On a CUDA tensor it launches the hand-written
Hopper kernel in ``cfgpp_tpu_torch/csrc/int8_conv.cu`` (built at first use,
see `cfgpp_tpu_torch.kernels.build`); on a CPU tensor it computes
`int8_conv3x3_reference`, the plain PyTorch version.  There is no fallback
from the kernel: a tensor it does not take raises.

The recipe is the TPU kernel's (not the JAX oracle's, which divides by the
scale): an optional f32 prologue ``silu(x*gn_scale + gn_bias)`` (the
GroupNorm + SiLU collapse of `cfgpp_tpu_torch.models.quant.
groupnorm_silu_coeffs`), after which the zero-padded columns and the rows
beyond each sample's edge are set back to zero; one activation scale per
(sample, window of ``br`` output rows and their two halo rows),
``sx = max(amax, 1e-6) * (1/127)``; ``round(x * (1/sx))`` half to even,
clipped to +-127; nine shifted int8 products with exact int32 accumulation
against per-output-channel int8 weights; the dequant ``(acc*sx)*w_scale``,
then ``+ bias`` and ``+ residual`` in f32, one rounding to bf16 (the TPU
kernel's output dtype, whatever it reads), then ``.to(out_dtype)``.

Layouts: x [B, H, W, C] and residual/out [B, H, W, O] (the JAX package's
NHWC; the port's NCHW channels_last tensors are this memory seen through
``permute(0, 2, 3, 1)``); weights int8 ``w_q [O, 3, 3, C]`` (channel
dimension contiguous, so a tap's 16-channel slice is one 16-byte load) with
one f32 scale per output channel.

On a CUDA tensor x, the residual and the output are all bf16 or all f32
(the TPU kernel reads either); x's dtype picks the entry point
(``cfgpp_int8_conv3x3`` or ``cfgpp_int8_conv3x3_f32``) and ``out_dtype``
must equal it.  An f32 output holds bf16-rounded values, exactly what JAX's
bf16 result cast to f32 holds.

The kernel quantizes each window once into an int8 buffer ``xq [B*H/br,
br+2, W, C]`` (the layout of `conv_windows_reference`) and runs the conv as
an implicit GEMM over it; `conv_gemm_operands_reference` builds that GEMM's
operands the way the kernel addresses them.  `int8_conv3x3_stages`
launches the same kernel and also returns the window buffer it read and the
scales, so that a check can hold each stage against `conv_windows_reference`
and `window_conv_reference`.

``conv_launches`` counts the kernel launches of this process
(`reset_launches` sets it to 0).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

conv_launches = 0


def reset_launches() -> None:
    global conv_launches
    conv_launches = 0


# ------------------------------------------------- numerics chosen on the TPU
# `scale_window_rows` and `int8_conv3x3_supported` are copies of the JAX
# package's block picker and routing predicate.  They were tuned on TPU v5e,
# but they decide which numbers the model computes (the scale granularity and
# which convs quantize their activations), so the port follows them exactly
# to stay comparable with the reference.
_VMEM_BUDGET = 22 * 1024 * 1024


def _vmem_est(br: int, wp: int, c: int, bo: int) -> int:
    w = wp - 2
    return (br * wp * c * 2 * 3 * 2
            + 3 * (br + 2) * w * c
            + (br + 2) * wp * c * 4
            + 9 * c * bo * 2
            + br * w * bo * 2 * 2
            + br * w * bo * 8)


_BEST_BLOCKS = {
    (128, 128, 320, 320): (8, 320),
    (128, 128, 640, 640): (4, 640),
    (128, 128, 640, 320): (4, 320),
    (128, 128, 960, 320): (4, 320),
    (64, 64, 640, 640): (8, 640),
    (64, 64, 960, 640): (8, 128),
    (64, 64, 1280, 640): (8, 128),
    (64, 64, 1280, 1280): (8, 256),
    (64, 64, 1920, 640): (8, 640),
    (32, 32, 640, 1280): (32, 256),
    (32, 32, 1280, 1280): (16, 256),
    (32, 32, 1920, 1280): (8, 256),
    (32, 32, 2560, 1280): (8, 128),
}


def scale_window_rows(h: int, w: int, c: int, o: int) -> int:
    """Output rows per activation-scale window, ``br`` of
    ``cfgpp_tpu/kernels/int8_conv.py:_pick_blocks``.

    On the TPU this is a tiling; here it decides numerics only: each window
    of ``br`` output rows (plus its two halo rows) shares one activation
    scale.  The Hopper kernel tiles independently of it."""
    if (h, w, c, o) in _BEST_BLOCKS:
        return _BEST_BLOCKS[h, w, c, o][0]
    bo_opts = [b for b in (640, 512, 384, 256, 128) if b <= o and o % b == 0]
    if o <= 640:
        bo_opts.insert(0, o)
    bo_opts = bo_opts or [o]
    m_target = 1024 if (c < 512 or (h <= 32 and c <= 640)) else 512
    br_opts = sorted((b for b in (32, 16, 8, 4, 2, 1) if h % b == 0),
                     key=lambda b: (b * w < m_target, abs(b * w - m_target)))
    for br in br_opts:
        for bo in bo_opts:
            if _vmem_est(br, w + 2, c, bo) <= _VMEM_BUDGET:
                return br
    return br_opts[-1]


def int8_conv3x3_supported(x_shape, strides, padding,
                           o: Optional[int] = None) -> bool:
    """Which 3x3 convs quantize their activations through `int8_conv3x3`
    (``cfgpp_tpu/kernels/int8_conv.py:int8_conv3x3_supported``): stride 1,
    pad 1, h >= 8, W a multiple of 32, c >= 128, and then
    ``c*o >= 640*1280``, or h >= 128, or h >= 64 with ``c*o >= 640*640``.
    Every other conv takes `QuantConv`'s dequantized-weight route."""
    b, h, w, c = x_shape
    if strides not in ((1, 1), None):
        return False
    if padding not in (1, ((1, 1), (1, 1))):
        return False
    if not (h >= 8 and w >= 32 and w % 32 == 0 and c >= 128):
        return False
    if o is None:
        return True
    return (c * o >= 640 * 1280 or h >= 128
            or (h >= 64 and c * o >= 640 * 640))


# ---------------------------------------------------------------- plain version
def conv_prologue_reference(x: torch.Tensor,
                            gn_scale: Optional[torch.Tensor] = None,
                            gn_bias: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """x [B, H, W, C] as the kernel sees it before the quantize, in f32:
    ``silu(x*gn_scale + gn_bias)`` (per sample and channel), or x."""
    xf = x.float()
    if gn_scale is None:
        return xf
    xf = xf * gn_scale.float()[:, None, None, :] \
        + gn_bias.float()[:, None, None, :]
    return xf * torch.sigmoid(xf)


def conv_windows_reference(xf: torch.Tensor, br: int):
    """f32 [B, H, W, C] -> (int8-valued f32 windows [B*H/br, br+2, W, C],
    f32 scales [B*H/br]).  Window i holds output rows i*br .. i*br+br-1 of
    its sample and one halo row each side, zero beyond the sample's edge;
    its scale is taken over all of it, as the kernel quantizes: ``x *
    (1/sx)``, not ``x / sx``."""
    b, h, w, c = xf.shape
    pad = F.pad(xf, (0, 0, 0, 0, 1, 1))                # zero rows -1 and H
    rows = torch.arange(0, h, br, device=xf.device)[:, None] \
        + torch.arange(br + 2, device=xf.device)
    win = pad[:, rows].reshape(b * (h // br), br + 2, w, c)
    amax = win.abs().amax(dim=(1, 2, 3))
    sx = amax.clamp_min(1e-6) * (1.0 / 127.0)
    inv = (1.0 / sx)[:, None, None, None]
    return torch.clamp(torch.round(win * inv), -127.0, 127.0), sx


def window_sums_reference(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The int32 sums of the conv from quantized windows, exact in f64: xq
    [nb, br+2, W, C] int8 values (int8 or f32), w_q [O, 3, 3, C] -> [nb, br,
    W, O]."""
    acc = F.conv2d(xq.double().permute(0, 3, 1, 2),
                   w_q.double().permute(0, 3, 1, 2), padding=(0, 1))
    return acc.permute(0, 2, 3, 1)


def conv_gemm_operands_reference(xq: torch.Tensor, w_q: torch.Tensor):
    """The kernel's implicit GEMM as explicit operands: (A [M, 9*C], B [O,
    9*C]) with M = B*H*W output pixels and K in tap-major order (k = (dh*3 +
    dw)*C + c), so that ``A @ B.T`` holds the conv's int32 sums by output
    pixel (`window_sums_reference` reshaped to [M, O]).  Row m = (b*H + h)*W
    + w of A gathers, for each tap (dh, dw), row (win, h mod br + dh, w + dw
    - 1) of the window buffer xq [nb, br+2, W, C], win = (b*H + h) // br,
    and zeros for a column outside [0, W): exactly the addresses ``conv_s8``
    reads.  A plain function for the CPU tests; nothing on the card's path
    calls it."""
    nb, br2, w, c = xq.shape
    br = br2 - 2
    m = torch.arange(nb * br * w, device=xq.device)
    row, col = m // w, m % w
    win, hr = row // br, row % br
    taps = []
    for dh in range(3):
        for dw in range(3):
            src = col + dw - 1
            inside = (src >= 0) & (src < w)
            taps.append(torch.where(inside[:, None],
                                    xq[win, hr + dh, src.clamp(0, w - 1)], 0))
    return torch.cat(taps, dim=1), w_q.reshape(w_q.shape[0], 9 * c)


def window_conv_reference(xq: torch.Tensor, sx: torch.Tensor,
                          w_q: torch.Tensor, w_scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          residual: Optional[torch.Tensor] = None,
                          batch: int = 1) -> torch.Tensor:
    """The kernel's GEMM and epilogue from quantized windows, in f32: xq
    [nb, br+2, W, C] int8 values (int8 or f32) and sx [nb] -> [B, H, W, O]:
    `window_sums_reference`, ``(acc*sx)*w_scale``, + bias, + residual."""
    nb, br2, w, c = xq.shape
    o = w_q.shape[0]
    acc = window_sums_reference(xq, w_q)
    y = acc.float() * sx.float()[:, None, None, None] * w_scale.float()
    if bias is not None:
        y = y + bias.float()
    y = y.reshape(batch, -1, w, o)
    if residual is not None:
        y = y + residual.float()
    return y


def _check_args(x, w_q, w_scale, gn_scale, gn_bias, residual):
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC [B, H, W, C]; got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if (w_q.dtype != torch.int8 or w_q.ndim != 4
            or tuple(w_q.shape[1:]) != (3, 3, c)):
        raise ValueError(f"w_q must be int8 [O, 3, 3, {c}]; got {w_q.dtype} "
                         f"{tuple(w_q.shape)}")
    o = w_q.shape[0]
    if tuple(w_scale.shape) != (o,):
        raise ValueError(f"w_scale must be [{o}]; got {tuple(w_scale.shape)}")
    if (gn_scale is None) != (gn_bias is None):
        raise ValueError("gn_scale and gn_bias come together")
    if gn_scale is not None and (tuple(gn_scale.shape) != (b, c)
                                 or tuple(gn_bias.shape) != (b, c)):
        raise ValueError(f"gn_scale/gn_bias must be [{b}, {c}]")
    if residual is not None and tuple(residual.shape) != (b, h, w, o):
        raise ValueError(f"residual must be [{b}, {h}, {w}, {o}]; got "
                         f"{tuple(residual.shape)}")


def _window_rows(x, w_q, block_rows) -> int:
    b, h, w, c = x.shape
    br = block_rows or scale_window_rows(h, w, c, w_q.shape[0])
    if h % br:
        raise ValueError(f"block_rows={br} must divide H={h}")
    return br


def int8_conv3x3_reference(x: torch.Tensor, w_q: torch.Tensor,
                           w_scale: torch.Tensor,
                           bias: Optional[torch.Tensor] = None,
                           gn_scale: Optional[torch.Tensor] = None,
                           gn_bias: Optional[torch.Tensor] = None,
                           residual: Optional[torch.Tensor] = None,
                           out_dtype: torch.dtype = torch.bfloat16,
                           block_rows: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of `int8_conv3x3`."""
    _check_args(x, w_q, w_scale, gn_scale, gn_bias, residual)
    br = _window_rows(x, w_q, block_rows)
    xq, sx = conv_windows_reference(
        conv_prologue_reference(x, gn_scale, gn_bias), br)
    return window_conv_reference(xq, sx, w_q, w_scale, bias, residual,
                                 x.shape[0]).bfloat16().to(out_dtype)


# ----------------------------------------------------------------------- kernel
@functools.cache
def _lib():
    from cfgpp_tpu_torch.kernels.build import load_library

    lib = load_library("int8_conv")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.cfgpp_int8_conv3x3, lib.cfgpp_int8_conv3x3_f32):
        fn.argtypes = [p] * 11 + [i] * 6 + [p]
        fn.restype = i
    return lib


# The C entry point by activation dtype.
_ENTRIES = {torch.bfloat16: "cfgpp_int8_conv3x3",
            torch.float32: "cfgpp_int8_conv3x3_f32"}


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _f32(t: Optional[torch.Tensor], dev) -> Optional[torch.Tensor]:
    """Per-channel parameters as contiguous f32, 8-byte aligned (the kernel
    reads them two at a time)."""
    if t is None:
        return None
    if t.device != dev:
        raise ValueError(f"expected a tensor on {dev}, got {t.device}")
    t = t.float().contiguous()
    return t if t.data_ptr() % 8 == 0 else t.clone()


def _activation(t: torch.Tensor, dev, dtype, name: str) -> torch.Tensor:
    """An NHWC activation as contiguous, 16-byte aligned ``dtype`` on ``dev``
    (a channels_last NCHW tensor seen through ``permute(0, 2, 3, 1)``
    already is contiguous)."""
    if t.device != dev or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {dev}, got {t.dtype} "
                         f"on {t.device}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_dtype(x: torch.Tensor, out_dtype: torch.dtype) -> torch.dtype:
    """The kernel's activation dtype: x's, bf16 or f32, which ``out_dtype``
    must equal (the residual is checked against it where it is read)."""
    if x.dtype not in _ENTRIES:
        raise ValueError(f"x: expected bfloat16 or float32 on {x.device}, got "
                         f"{x.dtype}")
    if out_dtype != x.dtype:
        raise ValueError(f"the kernel writes x's dtype {x.dtype}, not "
                         f"{out_dtype}")
    return x.dtype


def int8_conv3x3(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 gn_scale: Optional[torch.Tensor] = None,
                 gn_bias: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None,
                 out_dtype: torch.dtype = torch.bfloat16,
                 block_rows: Optional[int] = None) -> torch.Tensor:
    """x [B, H, W, C] (*) w_q int8 [O, 3, 3, C] (per-channel f32 ``w_scale``
    [O]) -> [B, H, W, O]; stride 1, zero padding 1.

    ``gn_scale``/``gn_bias`` f32 [B, C]: the fused prologue
    ``silu(x*gn_scale + gn_bias)``.  ``residual`` [B, H, W, O]: added in the
    dequant epilogue.  ``block_rows``: the scale window (default
    `scale_window_rows`).  On a CUDA tensor x and residual are both bf16 or
    both f32, and the output has their dtype."""
    _check_args(x, w_q, w_scale, gn_scale, gn_bias, residual)
    if x.device.type == "cpu":
        return int8_conv3x3_reference(x, w_q, w_scale, bias, gn_scale,
                                      gn_bias, residual, out_dtype,
                                      block_rows)
    return int8_conv3x3_stages(x, w_q, w_scale, bias, gn_scale, gn_bias,
                               residual, out_dtype, block_rows)[0]


def int8_conv3x3_stages(x: torch.Tensor, w_q: torch.Tensor,
                        w_scale: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        gn_scale: Optional[torch.Tensor] = None,
                        gn_bias: Optional[torch.Tensor] = None,
                        residual: Optional[torch.Tensor] = None,
                        out_dtype: torch.dtype = torch.bfloat16,
                        block_rows: Optional[int] = None):
    """Launch the `int8_conv3x3` kernel on CUDA tensors and return ``(out,
    xq, sx)``: the output, the int8 window buffer the kernel quantized and
    its GEMM read [B*H/br, br+2, W, C] and their f32 scales [B*H/br], which
    checks hold against `conv_windows_reference`."""
    _check_args(x, w_q, w_scale, gn_scale, gn_bias, residual)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv3x3: no kernel for {x.device}")
    dev, dt = x.device, _kernel_dtype(x, out_dtype)
    b, h, w, c = x.shape
    o = w_q.shape[0]
    if c % 16 or o % 2:
        raise ValueError(f"the kernel takes C in multiples of 16 and O in "
                         f"multiples of 2; got C={c}, O={o}")
    if w_q.device != dev or not w_q.is_contiguous() or w_q.data_ptr() % 16:
        raise ValueError(f"w_q must be contiguous and 16-byte aligned on "
                         f"{dev}")
    br = _window_rows(x, w_q, block_rows)
    nb = b * h // br
    xc = _activation(x, dev, dt, "x")
    res = None if residual is None else _activation(residual, dev, dt,
                                                    "residual")
    ws, bs = _f32(w_scale, dev), _f32(bias, dev)
    gs, gb = _f32(gn_scale, dev), _f32(gn_bias, dev)
    out = torch.empty((b, h, w, o), dtype=dt, device=dev)
    amax = torch.empty((nb,), dtype=torch.int32, device=dev)
    sx = torch.empty((nb,), dtype=torch.float32, device=dev)
    xq = torch.empty((nb, br + 2, w, c), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), _ENTRIES[dt])(
            xc.data_ptr(), w_q.data_ptr(), ws.data_ptr(), _ptr(bs), _ptr(gs),
            _ptr(gb), _ptr(res), out.data_ptr(), amax.data_ptr(),
            sx.data_ptr(), xq.data_ptr(), b, h, w, c, o, br, stream)
    if err:
        raise RuntimeError(f"int8_conv3x3 kernel launch failed: CUDA error "
                           f"{err} (x {tuple(x.shape)}, w {tuple(w_q.shape)},"
                           f" br {br})")
    global conv_launches
    conv_launches += 1
    return out, xq, sx
