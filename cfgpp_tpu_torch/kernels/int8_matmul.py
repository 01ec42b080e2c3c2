"""W8A8 int8 matmul and the fused GEGLU feed-forward, with in-kernel
activation quantization.

`int8_matmul` and `int8_ff_geglu` are the counterparts of
``cfgpp_tpu/kernels/int8_matmul.py``'s functions of the same names.  On a
CUDA tensor they launch the hand-written Hopper kernels in
``cfgpp_tpu_torch/csrc/int8_matmul.cu`` (built at first use, see
`cfgpp_tpu_torch.kernels.build`); on a CPU tensor they compute
`int8_matmul_reference` / `int8_ff_geglu_reference`, the plain PyTorch
versions of the same functions.  There is no fallback from the kernels: a
tensor they do not take raises.

The recipe is the TPU kernels' (per-output-channel int8 weights; per-row
dynamic activation absmax, ``x * (1/sx)`` with ``sx = max(amax, 1e-6) / 127``,
round half to even, clip to +-127; int32 accumulation; rank-1 dequant;
f32 bias and residual before the one rounding to bf16, the TPU kernels'
output dtype whatever they read, then ``.to(out_dtype)``).  Weights are in
torch layout: ``w_q`` int8 [N, K], one f32 scale per output row.

On a CUDA tensor the activations (x, the residual and the output) are all
bf16 or all f32, as the TPU kernels read either: x's dtype picks the
kernels' entry points (``cfgpp_int8_matmul`` or ``cfgpp_int8_matmul_f32``,
and the same for the feed-forward), ``out_dtype`` must equal it, and
nothing is converted on the way in.  An f32 output holds bf16-rounded
values, exactly what JAX's bf16 result cast to f32 holds.

`int8_matmul_stages` and `int8_ff_geglu_stages` launch the same kernels
and also return what the kernel computed on the way (the quantized rows;
the feed-forward's f32 hidden state and its requantized rows), so that a
check can hold each stage against its plain counterpart
(`prologue_reference`, `quantize_rows`, `geglu_hidden_reference`,
`dequant_reference`).

``matmul_launches`` and ``ff_launches`` count the kernel launches of this
process (`reset_launches` sets them to 0).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

matmul_launches = 0
ff_launches = 0

_MODES = {None: 0, "ln": 1, "affine": 2}


def reset_launches() -> None:
    global matmul_launches, ff_launches
    matmul_launches = ff_launches = 0


# ---------------------------------------------------------------- plain version
def layernorm_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Token LayerNorm as the kernels fuse it: f32 statistics, biased
    variance as E[x^2] - mu^2, f32 out."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    xn = (xf - mu) * torch.rsqrt(var + eps)
    return xn * scale.float() + bias.float()


def quantize_rows(xf: torch.Tensor):
    """f32 [..., K] -> (int8-valued f32 [..., K], f32 [..., 1] scale), as the
    kernels quantize: ``x * (1/sx)``, not ``x / sx``."""
    amax = xf.abs().amax(-1, keepdim=True)
    sx = amax.clamp_min(1e-6) * (1.0 / 127.0)
    return torch.clamp(torch.round(xf * (1.0 / sx)), -127.0, 127.0), sx


def _int_dot(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int8 dot, returned as f32 (an int32 sum rounded once).  f64
    holds every partial sum exactly (127^2 * K < 2^53); f32 would not for
    K > 1040."""
    return (xq.double() @ w_q.double().t()).float()


def prologue_reference(x: torch.Tensor,
                       ln_scale: Optional[torch.Tensor] = None,
                       ln_bias: Optional[torch.Tensor] = None,
                       ln_eps: float = 1e-5,
                       affine_scale: Optional[torch.Tensor] = None,
                       affine_bias: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """x [..., K] as the kernels see it before the quantize, in f32: the
    fused LayerNorm, the per-(sample, channel) affine, or x itself."""
    if ln_scale is not None:
        return layernorm_ref(x, ln_scale, ln_bias, ln_eps)
    xf = x.float()
    if affine_scale is not None:
        b = affine_scale.shape[0]
        xf = (xf.reshape(b, -1, xf.shape[-1]) * affine_scale.float()[:, None]
              + affine_bias.float()[:, None]).reshape(xf.shape)
    return xf


def dequant_reference(xq: torch.Tensor, sx: torch.Tensor, w_q: torch.Tensor,
                      w_scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernels' GEMM and epilogue from quantized rows, in f32: xq
    [..., K] int8 values (int8 or f32), sx [..., 1] row scales; exact int
    dot with w_q [N, K], ``acc * sx * w_scale``, + bias, + residual."""
    y = _int_dot(xq, w_q) * sx * w_scale.float()
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    return y


def _gelu_erf(g: torch.Tensor) -> torch.Tensor:
    return g * 0.5 * (1.0 + torch.erf(g * 2.0 ** -0.5))


def geglu_hidden_reference(xq: torch.Tensor, sx: torch.Tensor,
                           w1_q: torch.Tensor, w1_scale: torch.Tensor,
                           bias1: Optional[torch.Tensor]) -> torch.Tensor:
    """The f32 hidden state of `int8_ff_geglu` from quantized rows:
    ``v * gelu_erf(g)`` with ``v | g`` the dequantized ``x @ W1 + b1``."""
    h = dequant_reference(xq, sx, w1_q, w1_scale, bias1)
    n = w1_q.shape[0] // 2
    return h[..., :n] * _gelu_erf(h[..., n:])


def _check_args(x, w_q, w_scale, ln_scale, affine_scale, affine_bias):
    if w_q.ndim != 2 or w_q.dtype != torch.int8:
        raise ValueError(f"w_q must be int8 [N, K]; got {w_q.dtype} "
                         f"{tuple(w_q.shape)}")
    n, k = w_q.shape
    if x.shape[-1] != k or tuple(w_scale.shape) != (n,):
        raise ValueError(f"x [..., {x.shape[-1]}], w_q {tuple(w_q.shape)} and "
                         f"w_scale {tuple(w_scale.shape)} do not agree")
    if ln_scale is not None and affine_scale is not None:
        raise ValueError("affine_* and ln_* fusions are mutually exclusive")
    if affine_scale is not None:
        if x.ndim != 3 or tuple(affine_scale.shape) != (x.shape[0], k) \
                or affine_bias is None:
            raise ValueError("the affine prologue takes x [B, T, K] with "
                             "affine_scale/affine_bias [B, K]")


def int8_matmul_reference(x: torch.Tensor, w_q: torch.Tensor,
                          w_scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          ln_scale: Optional[torch.Tensor] = None,
                          ln_bias: Optional[torch.Tensor] = None,
                          ln_eps: float = 1e-5,
                          affine_scale: Optional[torch.Tensor] = None,
                          affine_bias: Optional[torch.Tensor] = None,
                          residual: Optional[torch.Tensor] = None,
                          out_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """Plain PyTorch version of `int8_matmul`."""
    _check_args(x, w_q, w_scale, ln_scale, affine_scale, affine_bias)
    xq, sx = quantize_rows(prologue_reference(
        x, ln_scale, ln_bias, ln_eps, affine_scale, affine_bias))
    return dequant_reference(xq, sx, w_q, w_scale, bias,
                             residual).bfloat16().to(out_dtype)


def int8_ff_geglu_reference(x: torch.Tensor, w1_q: torch.Tensor,
                            w1_scale: torch.Tensor,
                            bias1: Optional[torch.Tensor],
                            w2_q: torch.Tensor, w2_scale: torch.Tensor,
                            bias2: Optional[torch.Tensor],
                            ln_scale: Optional[torch.Tensor] = None,
                            ln_bias: Optional[torch.Tensor] = None,
                            ln_eps: float = 1e-5,
                            residual: Optional[torch.Tensor] = None,
                            out_dtype: torch.dtype = torch.bfloat16
                            ) -> torch.Tensor:
    """Plain PyTorch version of `int8_ff_geglu`: the hidden state is
    requantized per row from f32."""
    _check_ff_args(x, w1_q, w1_scale, w2_q, w2_scale)
    xq, sx = quantize_rows(prologue_reference(x, ln_scale, ln_bias, ln_eps))
    hq, sh = quantize_rows(geglu_hidden_reference(xq, sx, w1_q, w1_scale,
                                                  bias1))
    return dequant_reference(hq, sh, w2_q, w2_scale, bias2,
                             residual).bfloat16().to(out_dtype)


def _check_ff_args(x, w1_q, w1_scale, w2_q, w2_scale):
    if w1_q.dtype != torch.int8 or w2_q.dtype != torch.int8:
        raise ValueError("w1_q and w2_q must be int8")
    n2, k = w1_q.shape
    o, n = w2_q.shape
    if n2 != 2 * n or x.shape[-1] != k:
        raise ValueError(f"x [..., {x.shape[-1]}], w1 {tuple(w1_q.shape)} "
                         f"(value | gate halves) and w2 {tuple(w2_q.shape)} "
                         "do not agree")
    if tuple(w1_scale.shape) != (n2,) or tuple(w2_scale.shape) != (o,):
        raise ValueError("w1_scale / w2_scale must be [2N] / [O]")


# ----------------------------------------------------------------------- kernel
@functools.cache
def _lib():
    from cfgpp_tpu_torch.kernels.build import load_library

    lib = load_library("int8_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    for suffix in _KERNEL_DTYPES.values():
        mm = getattr(lib, f"cfgpp_int8_matmul{suffix}")
        ff = getattr(lib, f"cfgpp_int8_ff_geglu{suffix}")
        mm.argtypes = [p] * 10 + [i] * 5 + [ctypes.c_float, p]
        ff.argtypes = [p] * 16 + [i] * 5 + [ctypes.c_float, p]
        mm.restype = ff.restype = i
    return lib


# Suffix of the C entry points' names by activation dtype.
_KERNEL_DTYPES = {torch.bfloat16: "", torch.float32: "_f32"}


def _entry(dtype: torch.dtype, name: str):
    """The C entry point ``name`` for activations of ``dtype``."""
    return getattr(_lib(), f"cfgpp_{name}{_KERNEL_DTYPES[dtype]}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _f32(t: Optional[torch.Tensor], dev, shape, name) -> Optional[torch.Tensor]:
    """Small per-channel parameters go to the kernel as contiguous f32,
    8-byte aligned (the kernels read them two at a time)."""
    if t is None:
        return None
    if t.device != dev or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {tuple(shape)} on {dev}, got "
                         f"{tuple(t.shape)} on {t.device}")
    t = t.float().contiguous()
    return t if t.data_ptr() % 8 == 0 else t.clone()


def _rows(t: torch.Tensor, dev, dtype, width: int,
          name: str) -> torch.Tensor:
    """An activation as contiguous, 16-byte aligned rows [M, width] of
    ``dtype`` on ``dev`` (the kernels read the residual two elements at a
    time)."""
    if t.device != dev or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {dev}, got {t.dtype} "
                         f"on {t.device}")
    t = t.reshape(-1, width)
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _kernel_args(x, w_q, ln_scale, ln_bias, affine_scale, affine_bias,
                 out_dtype):
    dev, dt = x.device, x.dtype
    if dt not in _KERNEL_DTYPES:
        raise ValueError(f"x: expected bfloat16 or float32 on {dev}, got {dt}")
    if out_dtype != dt:
        raise ValueError(f"the kernel writes x's dtype {dt}, not {out_dtype}")
    n, k = w_q.shape
    if k % 16 or n % 16:
        raise ValueError(f"the kernel takes K and N in multiples of 16; got "
                         f"K={k}, N={n}")
    if w_q.device != dev or not w_q.is_contiguous() or w_q.data_ptr() % 16:
        raise ValueError(f"w_q must be contiguous and 16-byte aligned on {dev}")
    x2 = _rows(x, dev, dt, k, "x")
    mode, g, b, per = None, None, None, 0
    if ln_scale is not None:
        mode, g, b = "ln", _f32(ln_scale, dev, (k,), "ln_scale"), \
            _f32(ln_bias, dev, (k,), "ln_bias")
    elif affine_scale is not None:
        shape = (x.shape[0], k)
        mode = "affine"
        g = _f32(affine_scale, dev, shape, "affine_scale")
        b = _f32(affine_bias, dev, shape, "affine_bias")
        per = x.shape[1]
    return dev, x2, mode, g, b, per


def _raise_on(err: int, what: str, shapes) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({shapes})")


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                ln_scale: Optional[torch.Tensor] = None,
                ln_bias: Optional[torch.Tensor] = None,
                ln_eps: float = 1e-5,
                affine_scale: Optional[torch.Tensor] = None,
                affine_bias: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x [..., K] @ w_q int8 [N, K]^T (per-row f32 ``w_scale`` [N]) -> [..., N].

    Optional fusions, as the TPU kernel's: ``ln_scale``/``ln_bias`` [K] (a
    pre-matmul LayerNorm), ``affine_scale``/``affine_bias`` [B, K] (a
    per-(sample, channel) ``x*s+b``; x must be [B, T, K]), ``bias`` [N] and
    ``residual`` [..., N] in the dequant epilogue.  On a CUDA tensor x and
    residual are both bf16 or both f32, and the output has their dtype."""
    _check_args(x, w_q, w_scale, ln_scale, affine_scale, affine_bias)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q, w_scale, bias, ln_scale, ln_bias,
                                     ln_eps, affine_scale, affine_bias,
                                     residual, out_dtype)
    return int8_matmul_stages(x, w_q, w_scale, bias, ln_scale, ln_bias, ln_eps,
                              affine_scale, affine_bias, residual,
                              out_dtype)[0]


def int8_matmul_stages(x: torch.Tensor, w_q: torch.Tensor,
                       w_scale: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       ln_scale: Optional[torch.Tensor] = None,
                       ln_bias: Optional[torch.Tensor] = None,
                       ln_eps: float = 1e-5,
                       affine_scale: Optional[torch.Tensor] = None,
                       affine_bias: Optional[torch.Tensor] = None,
                       residual: Optional[torch.Tensor] = None,
                       out_dtype: torch.dtype = torch.bfloat16):
    """Launch the `int8_matmul` kernel on CUDA tensors and return ``(out,
    xq, sx)``: the output and the quantized rows the kernel computed (int8
    [..., K] and f32 [..., 1]), which checks hold against `quantize_rows`."""
    _check_args(x, w_q, w_scale, ln_scale, affine_scale, affine_bias)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: no kernel for {x.device}")
    dev, x2, mode, g, b, per = _kernel_args(
        x, w_q, ln_scale, ln_bias, affine_scale, affine_bias, out_dtype)
    n, k = w_q.shape
    m = x2.shape[0]
    ws = _f32(w_scale, dev, (n,), "w_scale")
    bs = _f32(bias, dev, (n,), "bias")
    res = None if residual is None else _rows(residual, dev, x.dtype, n,
                                              "residual")
    if res is not None and res.shape[0] != m:
        raise ValueError(f"residual rows {res.shape[0]} != x rows {m}")
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    xq = torch.empty((m, k), dtype=torch.int8, device=dev)
    sx = torch.empty((m,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(x.dtype, "int8_matmul")(
            x2.data_ptr(), w_q.data_ptr(), ws.data_ptr(), _ptr(bs), _ptr(g),
            _ptr(b), _ptr(res), out.data_ptr(), xq.data_ptr(), sx.data_ptr(),
            m, n, k, _MODES[mode], per, ln_eps, stream)
    _raise_on(err, "int8_matmul", f"x {tuple(x.shape)}, w {tuple(w_q.shape)}")
    global matmul_launches
    matmul_launches += 1
    lead = x.shape[:-1]
    return (out.reshape(*lead, n), xq.reshape(*lead, k),
            sx.reshape(*lead, 1))


def int8_ff_geglu(x: torch.Tensor, w1_q: torch.Tensor, w1_scale: torch.Tensor,
                  bias1: Optional[torch.Tensor], w2_q: torch.Tensor,
                  w2_scale: torch.Tensor, bias2: Optional[torch.Tensor],
                  ln_scale: Optional[torch.Tensor] = None,
                  ln_bias: Optional[torch.Tensor] = None,
                  ln_eps: float = 1e-5,
                  residual: Optional[torch.Tensor] = None,
                  out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The whole GEGLU feed-forward, W8A8: ``v * gelu_erf(g) @ W2 + b2`` with
    ``v | g = x @ W1 + b1``.  w1_q int8 [2N, K] (value rows, then gate rows:
    diffusers' ff.net.0.proj), w2_q int8 [O, N] (ff.net.2).  Optional
    pre-LayerNorm on x and residual on the output, as `int8_matmul`'s."""
    _check_ff_args(x, w1_q, w1_scale, w2_q, w2_scale)
    if x.device.type == "cpu":
        return int8_ff_geglu_reference(x, w1_q, w1_scale, bias1, w2_q,
                                       w2_scale, bias2, ln_scale, ln_bias,
                                       ln_eps, residual, out_dtype)
    return int8_ff_geglu_stages(x, w1_q, w1_scale, bias1, w2_q, w2_scale,
                                bias2, ln_scale, ln_bias, ln_eps, residual,
                                out_dtype)[0]


def int8_ff_geglu_stages(x: torch.Tensor, w1_q: torch.Tensor,
                         w1_scale: torch.Tensor,
                         bias1: Optional[torch.Tensor], w2_q: torch.Tensor,
                         w2_scale: torch.Tensor, bias2: Optional[torch.Tensor],
                         ln_scale: Optional[torch.Tensor] = None,
                         ln_bias: Optional[torch.Tensor] = None,
                         ln_eps: float = 1e-5,
                         residual: Optional[torch.Tensor] = None,
                         out_dtype: torch.dtype = torch.bfloat16):
    """Launch the `int8_ff_geglu` kernel on CUDA tensors and return ``(out,
    xq, sx, h, hq, sh)``: the output, the quantized input rows, the f32
    hidden state [..., N] and its requantized rows, for checks."""
    _check_ff_args(x, w1_q, w1_scale, w2_q, w2_scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_ff_geglu: no kernel for {x.device}")
    dev, x2, mode, g, b, _ = _kernel_args(
        x, w1_q, ln_scale, ln_bias, None, None, out_dtype)
    n2, k = w1_q.shape
    o, n = w2_q.shape
    if (n % 16 or o % 16 or not w2_q.is_contiguous() or w2_q.device != dev
            or w2_q.data_ptr() % 16):
        raise ValueError(f"w2_q must be contiguous and 16-byte aligned on "
                         f"{dev} with N, O in multiples of 16; got "
                         f"{tuple(w2_q.shape)}")
    m = x2.shape[0]
    s1 = _f32(w1_scale, dev, (n2,), "w1_scale")
    b1 = _f32(bias1, dev, (n2,), "bias1")
    s2 = _f32(w2_scale, dev, (o,), "w2_scale")
    b2 = _f32(bias2, dev, (o,), "bias2")
    res = None if residual is None else _rows(residual, dev, x.dtype, o,
                                              "residual")
    if res is not None and res.shape[0] != m:
        raise ValueError(f"residual rows {res.shape[0]} != x rows {m}")
    out = torch.empty((m, o), dtype=x.dtype, device=dev)
    xq = torch.empty((m, k), dtype=torch.int8, device=dev)
    sx = torch.empty((m,), dtype=torch.float32, device=dev)
    h = torch.empty((m, n), dtype=torch.float32, device=dev)
    hq = torch.empty((m, n), dtype=torch.int8, device=dev)
    sh = torch.empty((m,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(x.dtype, "int8_ff_geglu")(
            x2.data_ptr(), w1_q.data_ptr(), s1.data_ptr(), _ptr(b1),
            w2_q.data_ptr(), s2.data_ptr(), _ptr(b2), _ptr(g), _ptr(b),
            _ptr(res), out.data_ptr(), xq.data_ptr(), sx.data_ptr(),
            h.data_ptr(), hq.data_ptr(), sh.data_ptr(),
            m, n, k, o, _MODES[mode], ln_eps, stream)
    _raise_on(err, "int8_ff_geglu", f"x {tuple(x.shape)}, w1 "
              f"{tuple(w1_q.shape)}, w2 {tuple(w2_q.shape)}")
    global ff_launches
    ff_launches += 1
    lead = x.shape[:-1]
    return (out.reshape(*lead, o), xq.reshape(*lead, k), sx.reshape(*lead, 1),
            h.reshape(*lead, n), hq.reshape(*lead, n), sh.reshape(*lead, 1))
