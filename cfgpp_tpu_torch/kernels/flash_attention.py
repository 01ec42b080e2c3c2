"""Non-causal flash attention on token-major ``[B, N, H*D]`` activations.

`flash_attention_hd` and `flash_attention_qkv_packed` are the counterparts
of the functions of the same names in ``cfgpp_tpu/kernels/
flash_attention.py``.  On a CUDA tensor they launch the hand-written Hopper
kernel in ``cfgpp_tpu_torch/csrc/flash_attention.cu`` (built at first use,
see `cfgpp_tpu_torch.kernels.build`); on a CPU tensor they compute
`flash_attention_hd_reference` / `flash_attention_qkv_packed_reference`,
the plain PyTorch versions of the same functions.  There is no fallback
from the kernel: a tensor it does not take raises.

``launches`` and ``packed_launches`` count the kernel launches of this
process, so a run can show that its attention went through the kernel
(`reset_launches` sets both to 0).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

HEAD_DIMS = (40, 64, 80, 160, 512)   # the kernel's instantiations (csrc)

launches = 0
packed_launches = 0


def reset_launches() -> None:
    global launches, packed_launches
    launches = packed_launches = 0


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
    from cfgpp_tpu_torch.kernels.build import load_library

    lib = load_library("flash_attention")
    lib.cfgpp_flash_attention_hd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.cfgpp_flash_attention_qkv_packed.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.cfgpp_flash_attention_hd.restype = ctypes.c_int
    lib.cfgpp_flash_attention_qkv_packed.restype = ctypes.c_int
    return lib


def _check_kernel_inputs(num_heads: int, hd: int, **tensors) -> int:
    d = hd // num_heads
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: expected bf16 on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return d


def _launch_kernel(q, k, v, num_heads: int, n: int) -> torch.Tensor:
    d = _check_kernel_inputs(num_heads, q.shape[2], q=q, k=k, v=v)
    out = torch.empty_like(q)
    b, nq, _ = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().cfgpp_flash_attention_hd(
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
    it are masked.  CUDA tensors must be bf16 with D in `HEAD_DIMS`."""
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
        err = _lib().cfgpp_flash_attention_qkv_packed(
            qkv.data_ptr(), out.data_ptr(), b, n, num_heads, d, stream)
    if err:
        raise RuntimeError(f"flash_attention_qkv_packed kernel launch failed: "
                           f"CUDA error {err} (qkv {tuple(qkv.shape)}, heads "
                           f"{num_heads})")
    global packed_launches
    packed_launches += 1
    return out
