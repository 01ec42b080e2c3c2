"""The roofline helper's counts at SD-1.5 shapes, worked out by hand.

Flash attention: 4 B H Nq kv_len D flops.  int8_matmul: 2 M K N int8 ops
and the bytes of x, w, scales and out (+ LayerNorm vectors).  int8_conv3x3:
2 B H W 9 C O.  The bound is the larger of operations over the peak rate
and bytes over the memory rate, in ms.
"""

import pytest

from cfgpp_tpu_torch.utils import roofline as rl


def test_flash_attention_sd15_counts():
    l0 = rl.flash_attention(2, 4096, 4096, 8, 40)
    assert l0.bf16_flops == 42_949_672_960 and l0.int8_ops == 0
    assert l0.bytes == 2 * 2 * 320 * 4 * 4096   # q, k, v, o: [2, 4096, 320]
    vae = rl.flash_attention(1, 4096, 4096, 1, 512)
    assert vae.bf16_flops == 34_359_738_368
    cross = rl.flash_attention(2, 4096, 77, 8, 40)
    assert cross.bf16_flops == 4 * 2 * 8 * 4096 * 77 * 40
    assert cross.bytes == 2 * 2 * 320 * (2 * 4096 + 2 * 77)
    assert l0.bound_by() == "operations" and cross.bound_by() == "bytes"


def test_int8_attention_splits_the_products():
    w = rl.flash_attention_int8(2, 1024, 1024, 8, 80)
    bf16 = rl.flash_attention(2, 1024, 1024, 8, 80)
    assert w.int8_ops == w.bf16_flops == bf16.bf16_flops // 2
    assert w.bytes == bf16.bytes
    assert w.compute_ms() == pytest.approx(
        (w.bf16_flops / 989e12 + w.int8_ops / 1979e12) * 1e3)


def test_int8_matmul_l0_to_qkv():
    # x [2, 4096, 320] bf16, w [960, 320] int8, fused LayerNorm
    w = rl.int8_matmul(8192, 320, 960, ln=True)
    assert w.int8_ops == 5_033_164_800
    assert w.bytes == (8192 * 320 * 2 + 320 * 960 + 960 * 4
                       + 8192 * 960 * 2 + 2 * 320 * 4) == 21_285_120
    assert w.bound_by() == "bytes"
    assert w.bound_ms() == pytest.approx(21_285_120 / 3.35e12 * 1e3)


def test_int8_matmul_residual_and_bias_bytes():
    plain = rl.int8_matmul(128, 640, 640)
    full = rl.int8_matmul(128, 640, 640, bias=True, residual=True)
    assert full.bytes - plain.bytes == 640 * 4 + 128 * 640 * 2


def test_int8_ff_geglu_both_gemms():
    m, c = 8192, 320
    w = rl.int8_ff_geglu(m, c)
    assert w.int8_ops == 2 * m * c * 8 * c + 2 * m * 4 * c * c
    # x, out, residual; w1, w2; scales and biases; LN vectors
    assert w.bytes == (3 * m * c * 2 + 8 * c * c + 4 * c * c
                       + 2 * 8 * c * 4 + 2 * c * 4 + 2 * c * 4)


def test_int8_conv3x3_up_blocks_1_upsampler():
    w = rl.int8_conv3x3(2, 32, 32, 1280, 1280)
    assert w.int8_ops == 60_397_977_600
    assert w.bytes == (2048 * 1280 * 2 + 9 * 1280 * 1280 + 2 * 1280 * 4
                       + 2048 * 1280 * 2) == 25_241_600
    assert w.bound_by() == "operations"
    assert w.bound_ms() == pytest.approx(60_397_977_600 / 1979e12 * 1e3)
    gn = rl.int8_conv3x3(2, 32, 32, 1280, 1280, groupnorm=True, residual=True)
    assert gn.bytes - w.bytes == 2 * 2 * 1280 * 4 + 2048 * 1280 * 2


@pytest.mark.parametrize("flops,ops,nbytes", [
    (42_949_672_960, 0, 20_971_520), (0, 5_033_164_800, 21_285_120),
    (10**6, 10**6, 10**9), (0, 0, 0)])
def test_bound_is_the_larger_time(flops, ops, nbytes):
    w = rl.Work(bf16_flops=flops, int8_ops=ops, bytes=nbytes)
    compute = (flops / rl.BF16_FLOPS_PER_S + ops / rl.INT8_OPS_PER_S) * 1e3
    memory = nbytes / rl.BYTES_PER_S * 1e3
    assert w.bound_ms() == pytest.approx(max(compute, memory))
    assert w.bound_by() == ("operations" if compute >= memory else "bytes")


def test_peaks_are_the_h100_sxm_data_sheet():
    assert (rl.BF16_FLOPS_PER_S, rl.INT8_OPS_PER_S, rl.BYTES_PER_S) == (
        989e12, 1979e12, 3.35e12)
    # L0 self-attention's bound on the card: 43 us
    assert rl.flash_attention(2, 4096, 4096, 8, 40).bound_ms() == \
        pytest.approx(0.04343, rel=1e-3)
