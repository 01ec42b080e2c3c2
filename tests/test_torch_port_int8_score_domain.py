"""The int8-score attention's domain, and the arithmetic of its Hopper kernel.

Domain: the JAX functions ``flash_attention_hd_int8`` and
``flash_attention_qkv_packed_int8`` compute the int8 score only where the
whole kv sequence fits one TPU block (and, on the in-place packed route,
``n % 128 == 0``); elsewhere they run the bf16 flash attention.  The port's
functions, their plain versions and `int8_score_domain` follow the same
rule: held here against the JAX functions in interpret mode at two shapes
outside the domain, at the bf16 flash attention's f32 tolerance (1e-5 abs,
test_torch_port_attention.py), and against the JAX decision, read off the
JAX functions themselves (which kernel body they trace), at every SD-1.5 and
SDXL attention site.  Inside the domain test_torch_port_int8_all.py holds
the int8 score.

Arithmetic: ``csrc/flash_attention_int8.cu`` streams kv tiles with a
max-free softmax: per tile p = exp2(acc * (sq * (sk * q_scale))), rounded to
v's dtype, added to the row sum and to p@v in f32.  A plain emulation of
that order is held against `int8_score_attention_f32`: p bit for bit, the
output within f32 summation-order error, so the two bf16 writes differ by at
most one ulp (near a rounding tie).  That is the on-card rule of
``chip_smoke.py`` for the kernel.
"""

import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgpp_tpu_torch.kernels import flash_attention as tfa
from cfgpp_tpu_torch.tools import int8_ab

jax_fa = importlib.import_module("cfgpp_tpu.kernels.flash_attention")
REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "cfgpp_tpu_torch" / "csrc" / "flash_attention_int8.cu"
ATOL = 1e-5


def T(a):
    return torch.from_numpy(np.array(a, order="C"))


# ------------------------------------------------------ outside the domain
def _packed_case():
    """[1, 200, 1920], 8 heads of d=80: the pack is read in place and
    200 % 128 != 0, so the JAX function runs the bf16 packed kernel."""
    rng = np.random.default_rng(200)
    qkv = rng.standard_normal((1, 200, 3 * 8 * 80)).astype(np.float32)
    want_int8 = jax_fa.flash_attention_qkv_packed_int8(
        jnp.asarray(qkv), 8, interpret=True)
    want_bf16 = jax_fa.flash_attention_qkv_packed(jnp.asarray(qkv), 8,
                                                  interpret=True)
    got = {"fn": tfa.flash_attention_qkv_packed_int8(T(qkv), 8),
           "reference": tfa.flash_attention_qkv_packed_int8_reference(
               T(qkv), 8)}
    return want_int8, want_bf16, got


def _hd_case():
    """q [1, 16, 320], k/v [1, 4200, 320], 8 heads of d=40: 4224 padded kv
    rows exceed one block, so the JAX function runs the bf16 kernel's
    streaming body."""
    rng = np.random.default_rng(4200)
    q = rng.standard_normal((1, 16, 320)).astype(np.float32)
    k, v = (rng.standard_normal((1, 4200, 320)).astype(np.float32)
            for _ in range(2))
    args = [jnp.asarray(a) for a in (q, k, v)]
    want_int8 = jax_fa.flash_attention_hd_int8(*args, 8, interpret=True)
    want_bf16 = jax_fa.flash_attention_hd(*args, 8, interpret=True)
    got = {"fn": tfa.flash_attention_hd_int8(T(q), T(k), T(v), 8),
           "reference": tfa.flash_attention_hd_int8_reference(
               T(q), T(k), T(v), 8)}
    return want_int8, want_bf16, got


@pytest.mark.parametrize("case", [_packed_case, _hd_case],
                         ids=["packed_n200", "hd_kv4200"])
def test_off_domain_matches_jax(case):
    want_int8, want_bf16, got = case()
    assert want_int8.dtype == jnp.float32   # the bf16 kernel's, not bf16
    np.testing.assert_array_equal(np.asarray(want_int8), np.asarray(want_bf16))
    for name, out in got.items():
        assert out.dtype == torch.float32 and out.shape == want_int8.shape, name
        np.testing.assert_allclose(out.numpy(), np.asarray(want_int8),
                                   atol=ATOL, rtol=0, err_msg=name)


def test_off_domain_out_dtype():
    """Outside the domain ``out_dtype`` still sets the result's type, as it
    does inside."""
    rng = np.random.default_rng(1)
    qkv = T(rng.standard_normal((1, 200, 3 * 8 * 80)).astype(np.float32))
    out = tfa.flash_attention_qkv_packed_int8(qkv, 8, out_dtype=torch.bfloat16)
    want = tfa.flash_attention_qkv_packed_reference(qkv, 8)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want.bfloat16())


@pytest.mark.parametrize("packed", [False, True])
def test_stages_raise_outside_domain(packed):
    rng = np.random.default_rng(2)
    if packed:
        qkv = T(rng.standard_normal((1, 200, 3 * 8 * 80)).astype(np.float32))
        call = lambda: tfa.flash_attention_qkv_packed_int8_stages(qkv, 8)  # noqa: E731
    else:
        q = T(rng.standard_normal((1, 16, 320)).astype(np.float32))
        k = T(rng.standard_normal((1, 4200, 320)).astype(np.float32))
        call = lambda: tfa.flash_attention_hd_int8_stages(q, k, k, 8)  # noqa: E731
    with pytest.raises(ValueError, match="outside the int8 score's domain"):
        call()


# ---------------------------------------------------- the domain predicate
# (nq, nkv, heads, d): SD-1.5 512^2 self-attention at levels 0/1/2 and the
# mid block, its cross-attention (77 tokens), SD-1.5 256^2, SDXL 1024^2
# levels 1 and 2 (d=64) with their cross-attention, and the two shapes above.
_SITES = [
    (4096, 4096, 8, 40), (1024, 1024, 8, 80), (256, 256, 8, 160),
    (64, 64, 8, 160), (4096, 77, 8, 40), (1024, 77, 8, 80),
    (1024, 1024, 8, 40), (256, 256, 8, 80), (16, 16, 8, 160),
    (4096, 4096, 10, 64), (1024, 1024, 20, 64), (4096, 77, 10, 64),
    (1024, 77, 20, 64),
    (200, 200, 8, 80), (16, 4200, 8, 40),
]


def _jax_traces_int8(monkeypatch, nq, nkv, heads, d, packed) -> bool:
    """Whether the JAX function traces ``_kernel_single_int8`` (jit removed,
    so nothing is cached)."""
    seen = []
    real = jax_fa._kernel_single_int8
    monkeypatch.setattr(jax_fa, "_kernel_single_int8",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    for name in ("flash_attention_hd", "flash_attention_hd_int8",
                 "flash_attention_qkv_packed",
                 "flash_attention_qkv_packed_int8"):
        fn = getattr(jax_fa, name)
        monkeypatch.setattr(jax_fa, name, getattr(fn, "__wrapped__", fn))
    hd = heads * d
    if packed:
        jax.eval_shape(
            lambda x: jax_fa.flash_attention_qkv_packed_int8(x, heads),
            jax.ShapeDtypeStruct((2, nq, 3 * hd), jnp.bfloat16))
    else:
        jax.eval_shape(
            lambda q, k, v: jax_fa.flash_attention_hd_int8(q, k, v, heads),
            jax.ShapeDtypeStruct((2, nq, hd), jnp.bfloat16),
            *[jax.ShapeDtypeStruct((2, nkv, hd), jnp.bfloat16)] * 2)
    return bool(seen)


@pytest.mark.parametrize(
    "nq,nkv,heads,d,packed",
    [(*site, False) for site in _SITES]
    + [(*site, True) for site in _SITES if site[0] == site[1]])
def test_domain_matches_jax_decision(monkeypatch, nq, nkv, heads, d, packed):
    """Both entry points; the packed one (self-attention) where nq == nkv."""
    assert tfa.int8_score_domain(nq, nkv, heads, d, packed) == \
        _jax_traces_int8(monkeypatch, nq, nkv, heads, d, packed)


# ------------------------------------------------- the kernel's arithmetic
def _kv_tile(d: int) -> int:
    """The kernel's kv tile rows (``launch`` in the source)."""
    return 32 if d > 128 else 64


def test_kv_tile_rule_is_the_sources():
    assert "constexpr int BKV = D > 128 ? 32 : 64;" in SOURCE.read_text()


def _kernel_order(q, k, v, heads, n, bkv):
    """The kernel's order on the CPU: kv tiles of ``bkv`` rows, per tile the
    int scores dequantized, masked, p = exp2(s) rounded to v's dtype and no
    max subtracted, the row sum of those p and p@v added in f32 tile by
    tile; then out = acc / max(l, 1e-37).  Returns (out, p)."""
    b, nq, hd = q.shape
    nkv, d = k.shape[1], hd // heads
    qq, sq, kq, sk = tfa.quantize_qk_reference(q, k, heads)
    qh = qq.double().reshape(b, nq, heads, d).transpose(1, 2)
    kh = kq.double().reshape(b, nkv, heads, d).transpose(1, 2)
    vh = v.float().reshape(b, nkv, heads, d).transpose(1, 2)
    q_scale = torch.tensor(d ** -0.5 * tfa.LOG2E, dtype=torch.float32)
    fac = sq.transpose(1, 2)[..., None] * (sk * q_scale)[:, :, None, None]
    acc = torch.zeros(b, heads, nq, d)
    l = torch.zeros(b, heads, nq, 1)
    ps = []
    for kv0 in range(0, n, bkv):
        sl = slice(kv0, min(kv0 + bkv, n))
        s = (qh @ kh[:, :, sl].transpose(-1, -2)).float() * fac
        p = torch.exp2(s).to(v.dtype).float()
        ps.append(p)
        l = l + p.sum(-1, keepdim=True)
        acc = acc + p @ vh[:, :, sl]
    out = acc / l.clamp_min(1e-37)
    return out.transpose(1, 2).reshape(b, nq, hd), torch.cat(ps, dim=-1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_kernel_order_matches_plain(d, dtype):
    heads, nq, nkv, n = 2, 96, 200, 171       # a ragged last tile, masked
    rng = np.random.default_rng(d)
    q, k, v = (T(rng.standard_normal((2, r, heads * d)).astype(np.float32)
                 ).to(dtype) for r in (nq, nkv, nkv))
    got, p = _kernel_order(q, k, v, heads, n, _kv_tile(d))
    want_p = tfa.int8_score_probs(q, k, heads, n, dtype)
    assert torch.equal(p, want_p[..., :n])           # bit for bit
    assert not want_p[..., n:].any()                 # the masked columns
    want = tfa.int8_score_attention_f32(q, k, v, heads, n)
    slack = 1e-5 * want.abs().max().item()
    assert (got - want).abs().max().item() <= slack
    # chip_smoke.py's rules: each bf16 write is the rounding of a value
    # within the slack of the plain value (check_bf16_write), and at most
    # ULP_SHARE of them lie beyond one bf16 ulp of its rounding (outputs
    # near 0, where the slack is many of their ulps)
    out = got.bfloat16().float()
    assert ((out >= (want - slack).bfloat16().float())
            & (out <= (want + slack).bfloat16().float())).all()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -100)))
                     - 7)
    beyond = ((out - want.bfloat16().float()).abs() > ulp).float().mean()
    assert beyond.item() <= 1e-3


# ------------------------------------------------------- the A/B's profile
def test_int8_ab_profiles_the_sources_kernels():
    kernels = set(re.findall(r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s+)*"
                             r"(\w+)\s*\(", SOURCE.read_text()))
    names = int8_ab.PROFILED["flash_attention_int8"]
    assert names and set(names) <= kernels, (names, kernels)
