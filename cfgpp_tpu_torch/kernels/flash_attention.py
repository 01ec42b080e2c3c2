"""Non-causal flash attention on token-major ``[B, N, H*D]`` activations.

`flash_attention_hd` and `flash_attention_qkv_packed` are the counterparts
of the functions of the same names in ``cfgpp_tpu/kernels/
flash_attention.py``.  On a CUDA tensor they launch a hand-written Hopper
kernel (built at first use, see `cfgpp_tpu_torch.kernels.build`), chosen by
the inputs' dtype: bf16 in ``cfgpp_tpu_torch/csrc/flash_attention.cu``, f32
in ``cfgpp_tpu_torch/csrc/flash_attention_f32.cu``.  On a CPU tensor they
compute `flash_attention_hd_reference` / `flash_attention_qkv_packed_reference`,
the plain PyTorch versions of the same functions.  There is no fallback
from the kernels: a tensor they do not take raises.

`flash_attention_hd_int8` and `flash_attention_qkv_packed_int8` are the
int8-score counterparts (the score dot in int8, per-row q scales and one
scalar k scale per (batch, head); p rounded to v's dtype and p@v in it:
bf16, or f32 for f32 inputs; the output rounded to bf16, the TPU kernels'
output dtype, then held in ``out_dtype``), with the hand-written kernel in
``cfgpp_tpu_torch/csrc/flash_attention_int8.cu`` (both dtypes) and the plain
versions `flash_attention_hd_int8_reference` /
`flash_attention_qkv_packed_int8_reference`.  Like the JAX functions, they
compute the int8 score only inside its domain (`int8_score_domain`: one kv
block on the TPU) and the bf16 / f32 flash attention outside it, through
`flash_attention_hd` / `flash_attention_qkv_packed` and their counters.
`int8_score_applies` says where the quantized UNet's self-attention takes
them: exactly where the JAX package's TPU route runs ``_kernel_single_int8``.

``launches``, ``packed_launches``, ``int8_launches`` and
``packed_int8_launches`` count the kernel launches of this process (bf16
and f32 alike for the first two), so a run can show that its attention went
through the kernels (`reset_launches` sets them to 0).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

HEAD_DIMS = (40, 64, 80, 160, 512)   # the kernels' instantiations (csrc)
INT8_HEAD_DIMS = (40, 64, 80, 160)   # the int8-score kernel's
LOG2E = 1.4426950408889634

launches = 0
packed_launches = 0
int8_launches = 0
packed_int8_launches = 0


def reset_launches() -> None:
    global launches, packed_launches, int8_launches, packed_int8_launches
    launches = packed_launches = int8_launches = packed_int8_launches = 0


def _check_shapes(q, k, v, num_heads: int, kv_len: Optional[int]) -> int:
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"expected q [B,Nq,H*D] and k/v [B,Nkv,H*D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} differ "
                         "in batch or channels")
    if q.shape[2] % num_heads:
        raise ValueError(f"channel dim {q.shape[2]} not divisible by "
                         f"{num_heads} heads")
    n = k.shape[1] if kv_len is None else kv_len
    if not 1 <= n <= k.shape[1]:
        raise ValueError(f"kv_len={kv_len} outside [1, {k.shape[1]}]")
    return n


def flash_attention_hd_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, num_heads: int,
                                 kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: f32 softmax(q k^T / sqrt(d)) v, kv rows at or
    past ``kv_len`` masked.  Returns the input dtype."""
    n = _check_shapes(q, k, v, num_heads, kv_len)
    b, nq, hd = q.shape
    d = hd // num_heads
    qh = q.float().reshape(b, nq, num_heads, d).transpose(1, 2)
    kh = k[:, :n].float().reshape(b, n, num_heads, d).transpose(1, 2)
    vh = v[:, :n].float().reshape(b, n, num_heads, d).transpose(1, 2)
    probs = torch.softmax(qh @ kh.transpose(-1, -2) * d ** -0.5, dim=-1)
    out = (probs @ vh).transpose(1, 2).reshape(b, nq, hd)
    return out.to(q.dtype)


@functools.cache
def _lib():
    return _load("flash_attention", "")


@functools.cache
def _lib_f32():
    return _load("flash_attention_f32", "_f32")


def _load(name: str, suffix: str) -> ctypes.CDLL:
    from cfgpp_tpu_torch.kernels.build import load_library

    lib = load_library(name)
    hd = getattr(lib, f"cfgpp_flash_attention_hd{suffix}")
    packed = getattr(lib, f"cfgpp_flash_attention_qkv_packed{suffix}")
    hd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    packed.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    hd.restype = packed.restype = ctypes.c_int
    return lib


# Suffix of the C entry points' names by input dtype.
_KERNEL_DTYPES = {torch.bfloat16: "", torch.float32: "_f32"}


def _check_kernel_inputs(num_heads: int, hd: int, **tensors) -> int:
    """The kernels' conditions: D in `HEAD_DIMS`; every tensor on one device
    with one dtype, bf16 or f32, contiguous and 16-byte aligned."""
    d = hd // num_heads
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
    first = next(iter(tensors.values()))
    dev, dt = first.device, first.dtype
    if dt not in _KERNEL_DTYPES:
        raise ValueError(f"{next(iter(tensors))}: expected bfloat16 or float32"
                         f" on {dev}, got {dt}")
    for name, t in tensors.items():
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: expected {dt} on {dev} like the other "
                             f"inputs, got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return d


def _entry(dtype, name: str):
    """The C entry point ``name`` of the kernel library for ``dtype``."""
    lib = _lib() if dtype == torch.bfloat16 else _lib_f32()
    return getattr(lib, f"cfgpp_{name}{_KERNEL_DTYPES[dtype]}")


def _launch_kernel(q, k, v, num_heads: int, n: int) -> torch.Tensor:
    d = _check_kernel_inputs(num_heads, q.shape[2], q=q, k=k, v=v)
    out = torch.empty_like(q)
    b, nq, _ = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(q.dtype, "flash_attention_hd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, nq, k.shape[1], num_heads, d, n, stream)
    if err:
        raise RuntimeError(f"flash_attention_hd kernel launch failed: CUDA "
                           f"error {err} (q {tuple(q.shape)}, kv "
                           f"{tuple(k.shape)}, heads {num_heads})")
    global launches
    launches += 1
    return out


def flash_attention_hd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       num_heads: int,
                       kv_len: Optional[int] = None) -> torch.Tensor:
    """q: [B, Nq, H*D], k/v: [B, Nkv, H*D] -> [B, Nq, H*D].  Non-causal.

    ``kv_len``: the valid kv rows when k/v arrive padded; rows at or past
    it are masked.  CUDA tensors must be all bf16 or all f32, with D in
    `HEAD_DIMS`; the output has their dtype."""
    n = _check_shapes(q, k, v, num_heads, kv_len)
    if q.device.type == "cpu":
        return flash_attention_hd_reference(q, k, v, num_heads, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_hd: no kernel for {q.device}")
    return _launch_kernel(q, k, v, num_heads, n)


def _check_packed(qkv: torch.Tensor, num_heads: int) -> int:
    if qkv.ndim != 3 or qkv.shape[2] % (3 * num_heads):
        raise ValueError(f"expected a packed qkv [B, N, 3*H*D] for "
                         f"{num_heads} heads; got {tuple(qkv.shape)}")
    return qkv.shape[2] // 3


def flash_attention_qkv_packed_reference(qkv: torch.Tensor,
                                         num_heads: int) -> torch.Tensor:
    """Plain PyTorch version: q, k, v are the three channel thirds."""
    hd = _check_packed(qkv, num_heads)
    q, k, v = qkv.split(hd, dim=2)
    return flash_attention_hd_reference(q, k, v, num_heads)


def flash_attention_qkv_packed(qkv: torch.Tensor,
                               num_heads: int) -> torch.Tensor:
    """Self-attention on a packed [B, N, 3*H*D] projection (q | k | v on the
    channel dim) -> [B, N, H*D].  The kernel reads q, k and v in place as
    three channel-offset views; nothing is sliced into copies."""
    hd = _check_packed(qkv, num_heads)
    if qkv.device.type == "cpu":
        return flash_attention_qkv_packed_reference(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_qkv_packed: no kernel for "
                         f"{qkv.device}")
    d = _check_kernel_inputs(num_heads, hd, qkv=qkv)
    b, n, _ = qkv.shape
    out = torch.empty((b, n, hd), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(qkv.dtype, "flash_attention_qkv_packed")(
            qkv.data_ptr(), out.data_ptr(), b, n, num_heads, d, stream)
    if err:
        raise RuntimeError(f"flash_attention_qkv_packed kernel launch failed: "
                           f"CUDA error {err} (qkv {tuple(qkv.shape)}, heads "
                           f"{num_heads})")
    global packed_launches
    packed_launches += 1
    return out


# ------------------------------------------------------------ int8-score path
# Where the int8 score applies is a TPU tuning choice of the JAX package, but
# it decides which numbers the quantized model computes, so the port follows
# it exactly.  The helpers below are copies of the JAX route's pieces
# (``cfgpp_tpu/models/attention.py`` and ``cfgpp_tpu/kernels/
# flash_attention.py``); they decide numerics here, not a tiling.
FLASH_MIN_Q_LEN = 1024               # models/attention.py: flash from here on
_VMEM_BUDGET = 13 * 1024 * 1024      # kernels/flash_attention.py block picker


def _heads_per_block(num_heads: int, d: int) -> int:
    """``heads_per_block``: heads per TPU grid step (a 128-lane rule)."""
    if d % 128 == 0:
        return 1
    if 128 % d == 0:
        hpb = 128 // d
        if num_heads % hpb == 0:
            return hpb
    return num_heads


def _packed_views_legal(num_heads: int, d: int) -> bool:
    """``packed_views_legal``: whether the TPU reads the pack in place; if
    not, it splits the pack and runs ``flash_attention_hd_int8``, which has
    no ``n % 128`` condition."""
    return (_heads_per_block(num_heads, d) * d) % 128 == 0


def _single_pass_fits(nq: int, nkv_pad: int, d: int, hpb: int) -> bool:
    """The single-pass test of ``_pick_blocks``: the int8 score exists only
    in the one-kv-block kernel, which needs the whole sequence in one VMEM
    block (a single pass always takes ``bkv == nkv_pad``)."""
    ld = hpb * d

    def vmem(bq, bkv):
        blocks = (bq * ld + 2 * bkv * ld + bq * ld) * 2 * 2
        acc = bq * ld * 4 + bq * 8 * hpb * 8
        aug = 2 * bkv * 2 * d * 2 if (d == 64 and hpb == 2) else 0
        return blocks + bq * bkv * 4 + acc + aug

    if nkv_pad > 4096:
        return False
    bq = min(nq, 1024)
    while bq > 256 and vmem(bq, nkv_pad) > _VMEM_BUDGET:
        bq //= 2
    return vmem(bq, nkv_pad) <= _VMEM_BUDGET


def int8_score_domain(nq: int, nkv: int, num_heads: int, d: int,
                      packed: bool) -> bool:
    """Whether the JAX int8-score function runs ``_kernel_single_int8`` on
    nq query rows and nkv kv rows (k's rows, padded or not), ``num_heads``
    heads of dim d, rather than the bf16 flash attention.
    ``flash_attention_hd_int8``: one kv block (``_pick_blocks`` single pass
    at the kv rows padded to 128).  ``flash_attention_qkv_packed_int8``
    (``packed``, nq == nkv): the same plus ``n % 128 == 0`` where it reads
    the pack in place; where it may not (`_packed_views_legal`), it splits
    the pack and takes the hd rule."""
    hpb = _heads_per_block(num_heads, d)
    if not _single_pass_fits(nq, -(-nkv // 128) * 128, d, hpb):
        return False
    return not (packed and _packed_views_legal(num_heads, d)) or nq % 128 == 0


def int8_score_applies(n: int, num_heads: int, d: int) -> bool:
    """True exactly where the JAX package's TPU route runs the quantized
    UNet's self-attention (n tokens, ``num_heads`` heads of dim d) through
    ``_kernel_single_int8``: the flash path (n >= `FLASH_MIN_Q_LEN`, d a
    multiple of 8) and `int8_score_domain` of the packed entry point.
    Elsewhere it runs the bf16 kernel."""
    if n < FLASH_MIN_Q_LEN or d % 8:
        return False
    return int8_score_domain(n, n, num_heads, d, packed=True)


def _int8_domain_of(q, k, num_heads: int, packed: bool) -> bool:
    return int8_score_domain(q.shape[1], k.shape[1], num_heads,
                             q.shape[2] // num_heads, packed)


def quantize_qk_reference(q: torch.Tensor, k: torch.Tensor, num_heads: int):
    """q [B, Nq, H*D], k [B, Nkv, H*D] -> (qq, sq, kq, sk): int8-valued f32
    q and k in their input layouts, the per-(row, head) q scales [B, Nq, H]
    and the per-(batch, head) k scales [B, H], taken over every kv row.
    ``x * (1/s)``, not ``x / s``, as the kernels quantize."""
    b, nq, hd = q.shape
    nkv, d = k.shape[1], hd // num_heads
    qh = q.float().reshape(b, nq, num_heads, d)
    kh = k.float().reshape(b, nkv, num_heads, d)
    sq = qh.abs().amax(-1).clamp_min(1e-6) * (1.0 / 127.0)
    sk = kh.abs().amax(dim=(1, 3)).clamp_min(1e-6) * (1.0 / 127.0)
    qq = torch.clamp(torch.round(qh * (1.0 / sq)[..., None]), -127.0, 127.0)
    kq = torch.clamp(torch.round(kh * (1.0 / sk)[:, None, :, None]),
                     -127.0, 127.0)
    return qq.reshape(b, nq, hd), sq, kq.reshape(b, nkv, hd), sk


def flash_attention_hd_int8_reference(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor, num_heads: int,
                                      kv_len: Optional[int] = None,
                                      out_dtype: Optional[torch.dtype] = None
                                      ) -> torch.Tensor:
    """Plain PyTorch version of `flash_attention_hd_int8`: inside
    `int8_score_domain`, `int8_score_attention_f32` rounded to bf16 as the
    TPU kernel writes it; outside it `flash_attention_hd_reference`.
    Returns ``out_dtype`` (default: q's dtype)."""
    n = _check_shapes(q, k, v, num_heads, kv_len)
    if not _int8_domain_of(q, k, num_heads, packed=False):
        return flash_attention_hd_reference(q, k, v, num_heads, kv_len).to(
            out_dtype or q.dtype)
    return int8_score_attention_f32(q, k, v, num_heads, n).bfloat16().to(
        out_dtype or q.dtype)


def int8_score_probs(q: torch.Tensor, k: torch.Tensor, num_heads: int,
                     n: int, dtype: torch.dtype) -> torch.Tensor:
    """p [B, H, Nq, Nkv] (f32) of the int8-score attention: exact int q k^T
    (f64), ``s = acc * (sq * (sk * q_scale))``, kv rows at or past ``n``
    masked, ``p = exp2(s)`` with no max subtracted (the TPU kernel's
    one-block softmax), rounded to ``dtype`` (v's)."""
    b, nq, hd = q.shape
    nkv, d = k.shape[1], hd // num_heads
    qq, sq, kq, sk = quantize_qk_reference(q, k, num_heads)
    qh = qq.double().reshape(b, nq, num_heads, d).transpose(1, 2)
    kh = kq.double().reshape(b, nkv, num_heads, d).transpose(1, 2)
    acc = (qh @ kh.transpose(-1, -2)).float()            # [B, H, Nq, Nkv]
    q_scale = torch.tensor(d ** -0.5 * LOG2E, dtype=torch.float32)
    fac = sq.transpose(1, 2)[..., None] * (sk * q_scale)[:, :, None, None]
    s = acc * fac
    s[..., n:] = float("-inf")
    return torch.exp2(s).to(dtype).float()


def int8_score_attention_f32(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, num_heads: int,
                             n: int) -> torch.Tensor:
    """The int8-score attention's f32 result before its bf16 write:
    `int8_score_probs` p, ``(p@v) / max(sum p, 1e-37)``."""
    b, nq, hd = q.shape
    nkv, d = k.shape[1], hd // num_heads
    p = int8_score_probs(q, k, num_heads, n, v.dtype)
    vh = v.float().reshape(b, nkv, num_heads, d).transpose(1, 2)
    out = (p @ vh) / p.sum(-1, keepdim=True).clamp_min(1e-37)
    return out.transpose(1, 2).reshape(b, nq, hd)


def flash_attention_qkv_packed_int8_reference(
        qkv: torch.Tensor, num_heads: int,
        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version of `flash_attention_qkv_packed_int8`: outside
    `int8_score_domain`, `flash_attention_qkv_packed_reference`."""
    hd = _check_packed(qkv, num_heads)
    q, k, v = qkv.split(hd, dim=2)
    if not _int8_domain_of(q, k, num_heads, packed=True):
        return flash_attention_qkv_packed_reference(qkv, num_heads).to(
            out_dtype or qkv.dtype)
    return int8_score_attention_f32(q, k, v, num_heads, k.shape[1]).bfloat16(
        ).to(out_dtype or qkv.dtype)


@functools.cache
def _lib_int8():
    from cfgpp_tpu_torch.kernels.build import load_library

    lib = load_library("flash_attention_int8")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for suffix in _KERNEL_DTYPES.values():
        hd = getattr(lib, f"cfgpp_flash_attention_hd_int8{suffix}")
        packed = getattr(lib, f"cfgpp_flash_attention_qkv_packed_int8{suffix}")
        hd.argtypes = [p] * 9 + [i] * 6 + [f, p]
        packed.argtypes = [p] * 7 + [i] * 4 + [f, p]
        hd.restype = packed.restype = i
    return lib


def _int8_scratch_bytes(b: int, nkv: int, num_heads: int, d: int) -> int:
    """The kernel's scratch (``csrc/flash_attention_int8.cu``, the layout
    note above ``launch``): the k amax, 4 bytes per (batch, head), then from
    the next multiple of 128 bytes int8 k [B*H, Nkv rounded up to 64, d
    rounded up to 32]."""
    bh = b * num_heads
    return (-(-4 * bh // 128) * 128
            + bh * (-(-nkv // 64) * 64) * (-(-d // 32) * 32))


def _launch_int8(q, k, v, qkv, num_heads: int, n: int, stages: bool):
    """Launch the int8-score kernel on (q, k, v) or on a packed ``qkv``;
    returns (out, qq, sq, kq, sk), the stage outputs None unless
    ``stages``.  kq rows at or past n are not read by the kernel: zero."""
    x = q if qkv is None else qkv
    if not _int8_domain_of(q, k, num_heads, packed=qkv is not None):
        raise ValueError(
            f"int8-score attention: q {tuple(q.shape)}, kv {tuple(k.shape)}, "
            f"heads {num_heads} lie outside the int8 score's domain "
            "(int8_score_domain): the JAX function runs the bf16 kernel there")
    if x.device.type != "cuda":
        raise ValueError(f"int8-score attention: no kernel for {x.device}")
    b, nq, hd = q.shape
    nkv = k.shape[1]
    tensors = {"q": q, "k": k, "v": v} if qkv is None else {"qkv": qkv}
    d = _check_kernel_inputs(num_heads, hd, **tensors)
    if d not in INT8_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the int8 kernel's "
                         f"{INT8_HEAD_DIMS}")
    dev, suffix = x.device, _KERNEL_DTYPES[x.dtype]
    out = torch.empty((b, nq, hd), dtype=x.dtype, device=dev)
    scratch = torch.empty((_int8_scratch_bytes(b, nkv, num_heads, d),),
                          dtype=torch.uint8, device=dev)
    st = [None] * 4
    if stages:
        st = [torch.empty((b, nq, hd), dtype=torch.int8, device=dev),
              torch.empty((b, nq, num_heads), dtype=torch.float32, device=dev),
              torch.zeros((b, nkv, hd), dtype=torch.int8, device=dev),
              torch.empty((b, num_heads), dtype=torch.float32, device=dev)]
    ptrs = [None if t is None else t.data_ptr() for t in st]
    q_scale = d ** -0.5 * LOG2E
    entry = "hd_int8" if qkv is None else "qkv_packed_int8"
    fn = getattr(_lib_int8(), f"cfgpp_flash_attention_{entry}{suffix}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if qkv is None:
            err = fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), *ptrs, b, nq, nkv, num_heads, d, n,
                q_scale, stream)
        else:
            err = fn(
                qkv.data_ptr(), out.data_ptr(), scratch.data_ptr(), *ptrs, b,
                nq, num_heads, d, q_scale, stream)
    if err:
        shapes = ", ".join(f"{name} {tuple(t.shape)}"
                           for name, t in tensors.items())
        raise RuntimeError(f"int8-score attention kernel launch failed: CUDA "
                           f"error {err} ({shapes}, heads {num_heads})")
    global int8_launches, packed_int8_launches
    if qkv is None:
        int8_launches += 1
    else:
        packed_int8_launches += 1
    return (out, *st)


def _check_int8_out(out_dtype, x) -> None:
    """The kernel writes its inputs' dtype: ``out_dtype`` None or that."""
    if out_dtype not in (None, x.dtype):
        raise ValueError(f"the kernel writes the inputs' dtype {x.dtype}, "
                         f"not {out_dtype}")


def flash_attention_hd_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            num_heads: int, kv_len: Optional[int] = None,
                            out_dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """Int8-score attention: q [B, Nq, H*D], k/v [B, Nkv, H*D] ->
    [B, Nq, H*D], non-causal, kv rows at or past ``kv_len`` masked (the k
    scale still covers every row, as the TPU kernel's).  CUDA tensors must be
    all bf16 or all f32 with D in `INT8_HEAD_DIMS`; the output has their
    dtype there.  Outside `int8_score_domain` it is `flash_attention_hd`,
    as the JAX function falls back to the bf16 kernel."""
    n = _check_shapes(q, k, v, num_heads, kv_len)
    if q.device.type == "cpu":
        return flash_attention_hd_int8_reference(q, k, v, num_heads, kv_len,
                                                 out_dtype)
    _check_int8_out(out_dtype, q)
    if not _int8_domain_of(q, k, num_heads, packed=False):
        return flash_attention_hd(q, k, v, num_heads, kv_len)
    return _launch_int8(q, k, v, None, num_heads, n, stages=False)[0]


def flash_attention_qkv_packed_int8(qkv: torch.Tensor, num_heads: int,
                                    out_dtype: Optional[torch.dtype] = None
                                    ) -> torch.Tensor:
    """Int8-score self-attention on a packed [B, N, 3*H*D] projection ->
    [B, N, H*D]; q, k and v are read in place as channel-offset views.
    Outside `int8_score_domain` it is `flash_attention_qkv_packed`, as the
    JAX function falls back to the bf16 kernel."""
    hd = _check_packed(qkv, num_heads)
    if qkv.device.type == "cpu":
        return flash_attention_qkv_packed_int8_reference(qkv, num_heads,
                                                         out_dtype)
    _check_int8_out(out_dtype, qkv)
    q, k, v = qkv.split(hd, dim=2)
    if not _int8_domain_of(q, k, num_heads, packed=True):
        return flash_attention_qkv_packed(qkv, num_heads)
    return _launch_int8(q, k, v, qkv, num_heads, qkv.shape[1],
                        stages=False)[0]


def flash_attention_hd_int8_stages(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, num_heads: int,
                                   kv_len: Optional[int] = None):
    """Launch the int8-score kernel on CUDA tensors and return ``(out, qq,
    sq, kq, sk)``: the output and what the kernel quantized (int8 q [B, Nq,
    H*D], f32 q scales [B, Nq, H], int8 k [B, Nkv, H*D] with rows at or past
    ``kv_len`` zero, f32 k scales [B, H]), which checks hold against
    `quantize_qk_reference`.  Raises outside `int8_score_domain`, where no
    int8 stage exists."""
    n = _check_shapes(q, k, v, num_heads, kv_len)
    return _launch_int8(q, k, v, None, num_heads, n, stages=True)


def flash_attention_qkv_packed_int8_stages(qkv: torch.Tensor, num_heads: int):
    """`flash_attention_hd_int8_stages` for the packed entry point."""
    hd = _check_packed(qkv, num_heads)
    q, k, v = qkv.split(hd, dim=2)
    return _launch_int8(q, k, v, qkv, num_heads, qkv.shape[1], stages=True)
