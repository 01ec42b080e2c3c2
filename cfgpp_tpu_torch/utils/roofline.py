"""The least time an NVIDIA H100 could take for each kernel's work.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the card's memory rate, and
its operations over the peak rate of their type.  Operations are the
products' multiply-adds counted as two; a softmax's exponentials and a
quantizer's divisions are not counted.  The peaks are NVIDIA's H100 SXM data
sheet, dense (no sparsity), at the card's full 700 W power limit: 989
TFLOP/s bf16 and 1,979 TOP/s int8 on the tensor cores, 67 TFLOP/s f32 on
the CUDA cores (the f32 attention's products), 3.35 TB/s of HBM3.

Pure arithmetic on shapes: `chip_smoke.py` puts a bound beside every time it
measures, and the CPU tests check the counts.  The port's kernels never
call it.
"""

from __future__ import annotations

import dataclasses

BF16_FLOPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12
BYTES_PER_S = 3.35e12

BF16, INT8, F32 = 2, 1, 4   # bytes per element


@dataclasses.dataclass(frozen=True)
class Work:
    bf16_flops: int = 0     # bf16 tensor-core operations
    int8_ops: int = 0       # int8 tensor-core operations
    f32_flops: int = 0      # f32 operations on the CUDA cores
    bytes: int = 0          # device-memory bytes that must move

    def compute_ms(self) -> float:
        return (self.bf16_flops / BF16_FLOPS_PER_S
                + self.int8_ops / INT8_OPS_PER_S
                + self.f32_flops / F32_FLOPS_PER_S) * 1e3

    def memory_ms(self) -> float:
        return self.bytes / BYTES_PER_S * 1e3

    def bound_ms(self) -> float:
        return max(self.compute_ms(), self.memory_ms())

    def bound_by(self) -> str:
        return "operations" if self.compute_ms() >= self.memory_ms() else "bytes"


def flash_attention(batch: int, nq: int, kv_len: int, heads: int,
                    head_dim: int) -> Work:
    """Non-causal attention, bf16: q k^T and p v, 2 x 2 B H Nq kv_len D
    flops; q and o of Nq rows, k and v of the kv_len rows that are read."""
    hd = heads * head_dim
    return Work(
        bf16_flops=4 * batch * heads * nq * kv_len * head_dim,
        bytes=BF16 * batch * hd * (2 * nq + 2 * kv_len))


def flash_attention_f32(batch: int, nq: int, kv_len: int, heads: int,
                        head_dim: int) -> Work:
    """`flash_attention` in f32: the same operations on the CUDA cores, and
    twice the bytes."""
    bf16 = flash_attention(batch, nq, kv_len, heads, head_dim)
    return Work(f32_flops=bf16.bf16_flops, bytes=bf16.bytes * F32 // BF16)


def flash_attention_int8(batch: int, nq: int, kv_len: int, heads: int,
                         head_dim: int, act: int = BF16) -> Work:
    """Int8-score attention: q k^T in int8, p v in bf16 (``act`` = F32:
    f32 activations, p v on the CUDA cores); the same bytes as
    `flash_attention` in the activations' type (q and k are quantized on
    chip)."""
    bf16 = flash_attention(batch, nq, kv_len, heads, head_dim)
    half = bf16.bf16_flops // 2
    nbytes = bf16.bytes * act // BF16
    if act == F32:
        return Work(f32_flops=half, int8_ops=half, bytes=nbytes)
    return Work(bf16_flops=half, int8_ops=half, bytes=nbytes)


def int8_matmul(m: int, k: int, n: int, *, ln: bool = False,
                bias: bool = False, residual: bool = False,
                affine: int = 0, act: int = BF16) -> Work:
    """bf16 x [M, K] times int8 w [N, K] -> bf16 [M, N]: 2 M K N int8 ops;
    x, w, its f32 scales, the out, and the optional LayerNorm vectors,
    bias, residual and per-(sample, channel) affine prologue (``affine``:
    the number of samples).  ``act``: bytes per activation element (F32
    for f32 x, residual and out)."""
    nbytes = act * m * k + INT8 * k * n + F32 * n + act * m * n
    nbytes += F32 * 2 * k * ln + F32 * n * bias + act * m * n * residual
    nbytes += F32 * 2 * affine * k
    return Work(int8_ops=2 * m * k * n, bytes=nbytes)


def int8_ff_geglu(m: int, c: int, act: int = BF16) -> Work:
    """The feed-forward: LayerNorm, x [M, C] @ w1 [C, 8C] (GEGLU value and
    gate), gelu-gated product [M, 4C] @ w2 [4C, C]; both GEMMs in int8.  The
    hidden state is counted as on chip: what must move is x, both weights
    with their scales and biases, the LN vectors, the out and the
    residual (``act`` bytes per activation element)."""
    first = int8_matmul(m, c, 8 * c, ln=True, bias=True, act=act)
    second = int8_matmul(m, 4 * c, c, bias=True, residual=True, act=act)
    hidden = act * m * 8 * c + act * m * 4 * c   # first's out, second's x
    return Work(int8_ops=first.int8_ops + second.int8_ops,
                bytes=first.bytes + second.bytes - hidden)


def int8_conv3x3(batch: int, h: int, w: int, c: int, o: int, *,
                 groupnorm: bool = False, residual: bool = False,
                 act: int = BF16) -> Work:
    """3x3 stride-1 'same' conv, NHWC bf16 x, int8 weights [O, 3, 3, C]:
    2 B H W 9 C O int8 ops; x, w and its scales, the bias, the out, and
    the optional per-(sample, channel) GroupNorm coefficients and
    residual (``act`` bytes per activation element: F32 for f32)."""
    pixels = batch * h * w
    nbytes = (act * pixels * c + INT8 * 9 * c * o + F32 * 2 * o
              + act * pixels * o)
    nbytes += F32 * 2 * batch * c * groupnorm + act * pixels * o * residual
    return Work(int8_ops=2 * pixels * 9 * c * o, bytes=nbytes)
