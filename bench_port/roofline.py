"""The least time an NVIDIA H100 could take for each kernel's work.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the card's memory rate, and
its operations over the peak rate of their type.  Operations are the
products' multiply-adds counted as two; a softmax's exponentials and a
quantizer's divisions are not counted.  The peaks are NVIDIA's H100 SXM data
sheet, dense (no sparsity), at the card's full 700 W power limit: 989
TFLOP/s bf16 and 1,979 TOP/s int8 on the tensor cores, 3.35 TB/s of HBM3.

A frozen copy of the parts of ``cfgpp_tpu_torch/utils/roofline.py`` that
the benchmark's metrics read (its yardstick, which later changes to the
program do not move).
"""

from __future__ import annotations

import dataclasses

BF16_FLOPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
BYTES_PER_S = 3.35e12

BF16, INT8, F32 = 2, 1, 4   # bytes per element


@dataclasses.dataclass(frozen=True)
class Work:
    bf16_flops: int = 0     # bf16 tensor-core operations
    int8_ops: int = 0       # int8 tensor-core operations
    bytes: int = 0          # device-memory bytes that must move

    def compute_ms(self) -> float:
        return (self.bf16_flops / BF16_FLOPS_PER_S
                + self.int8_ops / INT8_OPS_PER_S) * 1e3

    def memory_ms(self) -> float:
        return self.bytes / BYTES_PER_S * 1e3

    def bound_ms(self) -> float:
        return max(self.compute_ms(), self.memory_ms())


def flash_attention(batch: int, nq: int, kv_len: int, heads: int,
                    head_dim: int) -> Work:
    """Non-causal attention, bf16: q k^T and p v, 2 x 2 B H Nq kv_len D
    flops; q and o of Nq rows, k and v of the kv_len rows that are read."""
    hd = heads * head_dim
    return Work(
        bf16_flops=4 * batch * heads * nq * kv_len * head_dim,
        bytes=BF16 * batch * hd * (2 * nq + 2 * kv_len))


def int8_matmul(m: int, k: int, n: int, *, ln: bool = False,
                bias: bool = False, residual: bool = False,
                affine: int = 0) -> Work:
    """bf16 x [M, K] times int8 w [N, K] -> bf16 [M, N]: 2 M K N int8 ops;
    x, w, its f32 scales, the out, and the optional LayerNorm vectors,
    bias, residual and per-(sample, channel) affine prologue (``affine``:
    the number of samples)."""
    nbytes = BF16 * m * k + INT8 * k * n + F32 * n + BF16 * m * n
    nbytes += F32 * 2 * k * ln + F32 * n * bias + BF16 * m * n * residual
    nbytes += F32 * 2 * affine * k
    return Work(int8_ops=2 * m * k * n, bytes=nbytes)


def int8_ff_geglu(m: int, c: int) -> Work:
    """The feed-forward: LayerNorm, x [M, C] @ w1 [C, 8C] (GEGLU value and
    gate), gelu-gated product [M, 4C] @ w2 [4C, C]; both GEMMs in int8.  The
    hidden state is counted as on chip: what must move is x, both weights
    with their scales and biases, the LN vectors, the out and the
    residual."""
    first = int8_matmul(m, c, 8 * c, ln=True, bias=True)
    second = int8_matmul(m, 4 * c, c, bias=True, residual=True)
    hidden = BF16 * m * 8 * c + BF16 * m * 4 * c   # first's out, second's x
    return Work(int8_ops=first.int8_ops + second.int8_ops,
                bytes=first.bytes + second.bytes - hidden)
