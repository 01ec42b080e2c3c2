"""The port's int8 kernels on f32 activations, against the JAX package.

The JAX int8 kernels take bf16 or f32 activations; the port's wrappers now
take either on a CUDA tensor too (all of x, the residual and the output in
one dtype) and launch the kernels' ``_f32`` entry points for f32.  The
kernels need the card (``chip_smoke.py`` holds them against their plain
versions there); here:

- the wrappers' input checks accept bf16 and f32, reject mixed and other
  dtypes, and take ``out_dtype`` equal to x's dtype only;
- the plain versions with f32 activations and f32 outputs against the
  Pallas kernels in interpret mode at SD-1.5 site widths (shorter
  sequences).  Both write bf16 (the port's f32 output holds bf16 values)
  from the same f32 value, so without a prologue the plain output equals
  the Pallas one cast to f32, except where that value lies within 1e-6 x
  max|ref| of a bf16 rounding tie (an f32 rounding of either side's
  multiply-adds): there one bf16 ulp (`assert_pallas_bf16_write`).  A
  LayerNorm or GroupNorm prologue and the feed-forward's hidden requantize
  may move one int8 level, as in bf16: then at most 0.1% of the elements
  may be beyond half a bf16 ulp, each within 2e-2 x max|ref|.  The
  int8-score attention's p is not rounded in f32 on either side: equal
  but within 1e-5 of a tie (exp2 and the sums differ in their last bits);
- an f32 ``--quant all`` UNet call hands every int8 entry point f32
  activations and gets f32 back, and every int8 layer's output holds bf16
  values.  The f32 ``--quant all`` engine against the JAX engine per step
  is test_torch_port_int8_all_engine.py's (its bundles are f32).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfgpp_tpu.kernels.int8_matmul as jax_int8
from cfgpp_tpu.models import quant as jax_quant
from cfgpp_tpu_torch.engine import ModelBundle
from cfgpp_tpu_torch.kernels import flash_attention as tfa
from cfgpp_tpu_torch.kernels import int8_conv as tc
from cfgpp_tpu_torch.kernels import int8_matmul as tk
from cfgpp_tpu_torch.models import attention as ta
from cfgpp_tpu_torch.models import quant as tq
from cfgpp_tpu_torch.models import unet as tu
from tests.torch_int8_route import assert_pallas_bf16_write

jax_fa = importlib.import_module("cfgpp_tpu.kernels.flash_attention")
jax_conv = importlib.import_module("cfgpp_tpu.kernels.int8_conv")

DTYPES = [torch.bfloat16, torch.float32]


def T(a):
    return torch.from_numpy(np.array(a, order="C"))


def _bf16_ulp(want):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -100)))
                   - 7)


def _assert_f32_within_pallas_bf16(got, want, flips: bool, unrounded=None,
                                   extra=1e-6):
    """``got`` (the port's f32 output, bf16 values) against ``want``
    (Pallas, bf16): without ``flips`` `assert_pallas_bf16_write` from the
    port's ``unrounded`` f32 value, with a tie slack of ``extra`` x
    max|want|; with ``flips`` (an int8 level may move) the flip rule."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    if not flips:
        assert_pallas_bf16_write(got, unrounded, want, extra * scale)
        return
    off = np.abs(got - want) > 0.5 * _bf16_ulp(want) + extra * scale
    assert off.mean() <= 1e-3, f"{off.sum()} of {off.size} elements differ"
    assert np.abs(got - want).max() <= 2e-2 * scale


# ------------------------------------------------------- the input checks
def _check(entry, dt, other, out):
    """Run ``entry``'s kernel input checks on CPU tensors: x (or q, or the
    packed qkv) of ``dt``, the residual (or k and v) of ``other``, and
    ``out_dtype`` ``out``."""
    x = torch.zeros(2, 16, 64, dtype=dt)
    w = torch.zeros(32, 64, dtype=torch.int8)
    if entry in ("int8_matmul", "int8_ff_geglu"):
        dev, x2 = tk._kernel_args(x, w, None, None, None, None, out)[:2]
        tk._rows(torch.zeros(2, 16, 32, dtype=other), dev, x2.dtype, 32,
                 "residual")
    elif entry == "int8_conv3x3":
        xc = torch.zeros(2, 8, 32, 64, dtype=dt)
        got = tc._kernel_dtype(xc, out)
        tc._activation(torch.zeros(2, 8, 32, 16, dtype=other), xc.device,
                       got, "residual")
    elif entry == "flash_attention_hd_int8":
        q = torch.zeros(2, 16, 320, dtype=dt)
        kv = torch.zeros(2, 24, 320, dtype=other)
        assert tfa._check_kernel_inputs(8, 320, q=q, k=kv, v=kv.clone()) == 40
        tfa._check_int8_out(out, q)
    else:
        qkv = torch.zeros(2, 16, 3 * 640, dtype=dt)
        assert tfa._check_kernel_inputs(8, 640, qkv=qkv) == 80
        tfa._check_int8_out(out, qkv)


ENTRIES = ["int8_matmul", "int8_ff_geglu", "int8_conv3x3",
           "flash_attention_hd_int8", "flash_attention_qkv_packed_int8"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("entry", ENTRIES)
def test_int8_kernel_inputs_take_bf16_and_f32(entry, dtype):
    _check(entry, dtype, dtype, dtype)
    if entry.startswith("flash"):
        _check(entry, dtype, dtype, None)      # default: the inputs' dtype


@pytest.mark.parametrize("entry", ENTRIES)
def test_int8_kernel_inputs_reject_mixed_and_other_dtypes(entry):
    f32, bf16 = torch.float32, torch.bfloat16
    if entry != "flash_attention_qkv_packed_int8":   # one tensor: not mixed
        for dt, other in ((f32, bf16), (bf16, f32)):
            with pytest.raises(ValueError, match="expected"):
                _check(entry, dt, other, dt)
    with pytest.raises(ValueError, match="expected bfloat16 or float32"):
        _check(entry, torch.float16, torch.float16, torch.float16)
    for dt, out in ((f32, bf16), (bf16, f32)):
        with pytest.raises(ValueError, match="writes"):
            _check(entry, dt, dt, out)


def test_f32_wrappers_on_cpu_use_reference_without_launch():
    rng = np.random.default_rng(17)
    x = T(rng.standard_normal((2, 8, 64)).astype(np.float32))
    wq = torch.randint(-127, 128, (32, 64), dtype=torch.int8)
    ws = torch.full((32,), 0.01)
    w2q = torch.randint(-127, 128, (64, 32), dtype=torch.int8)
    xc = T(rng.standard_normal((1, 8, 32, 32)).astype(np.float32))
    wc = torch.randint(-127, 128, (16, 3, 3, 32), dtype=torch.int8)
    qkv = T(rng.standard_normal((2, 64, 3 * 160)).astype(np.float32))
    f32 = torch.float32
    for mod in (tk, tc, tfa):
        mod.reset_launches()
    outs = [
        (tk.int8_matmul(x, wq, ws, out_dtype=f32),
         tk.int8_matmul_reference(x, wq, ws, out_dtype=f32)),
        (tk.int8_ff_geglu(x, torch.cat([wq, wq]), torch.cat([ws, ws]), None,
                          w2q, torch.full((64,), 0.01), None, out_dtype=f32),
         tk.int8_ff_geglu_reference(
             x, torch.cat([wq, wq]), torch.cat([ws, ws]), None, w2q,
             torch.full((64,), 0.01), None, out_dtype=f32)),
        (tc.int8_conv3x3(xc, wc, ws[:16], out_dtype=f32),
         tc.int8_conv3x3_reference(xc, wc, ws[:16], out_dtype=f32)),
        (tfa.flash_attention_qkv_packed_int8(qkv, 2),
         tfa.flash_attention_qkv_packed_int8_reference(qkv, 2)),
    ]
    for got, want in outs:
        assert got.dtype == f32 and torch.equal(got, want)
    assert tk.matmul_launches == tk.ff_launches == tc.conv_launches == \
        tfa.packed_int8_launches == 0


# -------------------------------------------- plain f32 versions vs Pallas
def _weights(rng, k, n):
    """int8 [K, N] (JAX layout) and its f32 [N] scale."""
    wq, ws = jax_quant.quantize_kernel_int8(
        (0.05 * rng.standard_normal((k, n))).astype(np.float32))
    return np.asarray(wq), np.asarray(ws)


# (site, K, N, mode): SD-1.5 widths of the --quant dense projections
MATMUL_SITES = [("L0 to_qkv", 320, 960, "ln"),
                ("L1 attn to_out", 640, 640, "bias_res"),
                ("L2 to_q", 1280, 1280, "ln"),
                ("L2 proj_in", 1280, 1280, "bias"),
                ("cross k/v", 768, 320, "none")]


@pytest.mark.parametrize("site,k,n,mode", MATMUL_SITES)
def test_int8_matmul_f32_reference_matches_pallas(site, k, n, mode):
    rng = np.random.default_rng(k + n + len(mode))
    m = 64
    x = (2.0 * rng.standard_normal((2, m, k)) + 0.3).astype(np.float32)
    wq, ws = _weights(rng, k, n)
    jkw, tkw = {}, {}

    def add(name, arr):
        jkw[name], tkw[name] = jnp.asarray(arr), T(arr)

    if mode in ("bias", "bias_res"):
        add("bias", (0.1 * rng.standard_normal(n)).astype(np.float32))
    if mode == "bias_res":
        add("residual", rng.standard_normal((2, m, n)).astype(np.float32))
    if mode == "ln":
        add("ln_scale", (1 + 0.1 * rng.standard_normal(k)).astype(np.float32))
        add("ln_bias", (0.1 * rng.standard_normal(k)).astype(np.float32))
    want = jax_int8.int8_matmul(jnp.asarray(x), jnp.asarray(wq),
                                jnp.asarray(ws), interpret=True, **jkw)
    got = tk.int8_matmul_reference(T(x), T(wq.T), T(ws),
                                   out_dtype=torch.float32, **tkw)
    pro = {k: v for k, v in tkw.items() if k.startswith("ln_")}
    unrounded = tk.dequant_reference(
        *tk.quantize_rows(tk.prologue_reference(T(x), **pro)), T(wq.T),
        T(ws), tkw.get("bias"), tkw.get("residual"))
    assert got.dtype == torch.float32 and want.dtype == jnp.bfloat16
    _assert_f32_within_pallas_bf16(got.numpy(), want, flips=mode == "ln",
                                   unrounded=unrounded)


@pytest.mark.parametrize("c", [320, 640])
def test_int8_ff_geglu_f32_reference_matches_pallas(c):
    rng = np.random.default_rng(c)
    m, n = 64, 4 * c
    x = rng.standard_normal((m, c)).astype(np.float32)
    w1q, w1s = _weights(rng, c, 2 * n)
    w2q, w2s = _weights(rng, n, c)
    b1 = (0.1 * rng.standard_normal(2 * n)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    be = (0.1 * rng.standard_normal(c)).astype(np.float32)
    r = rng.standard_normal((m, c)).astype(np.float32)
    want = jax_int8.int8_ff_geglu(
        jnp.asarray(x), jnp.asarray(w1q), jnp.asarray(w1s), jnp.asarray(b1),
        jnp.asarray(w2q), jnp.asarray(w2s), jnp.asarray(b2), gelu="erf",
        ln_scale=jnp.asarray(g), ln_bias=jnp.asarray(be),
        residual=jnp.asarray(r), interpret=True)
    got = tk.int8_ff_geglu_reference(
        T(x), T(w1q.T), T(w1s), T(b1), T(w2q.T), T(w2s), T(b2),
        ln_scale=T(g), ln_bias=T(be), residual=T(r), out_dtype=torch.float32)
    assert got.dtype == torch.float32
    # the hidden state passes through erf (a 1.5e-7 polynomial in the TPU
    # kernel) and a second quantize: held like a LayerNorm prologue
    _assert_f32_within_pallas_bf16(got.numpy(), want, flips=True)


# (c, o, GroupNorm prologue + residual): SD-1.5 widths of the int8 convs
@pytest.mark.parametrize("c,o,prologue", [(1280, 1280, False),
                                          (640, 640, False),
                                          (1920, 640, True),
                                          (640, 640, True)])
def test_int8_conv3x3_f32_reference_matches_pallas(c, o, prologue):
    rng = np.random.default_rng(c + o + prologue)
    b, h, w, br = 2, 8, 32, 4
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    wq, ws = jax_quant.quantize_conv_kernel_int8(
        rng.normal(0, 0.02, (3, 3, c, o)).astype(np.float32))
    jkw, tkw = {}, {}

    def add(name, arr):
        jkw[name], tkw[name] = jnp.asarray(arr), T(arr)

    add("bias", rng.normal(0, 0.1, (o,)).astype(np.float32))
    if prologue:
        add("gn_scale", rng.normal(1, 0.2, (b, c)).astype(np.float32))
        add("gn_bias", rng.normal(0, 0.3, (b, c)).astype(np.float32))
        add("residual", rng.normal(0, 1, (b, h, w, o)).astype(np.float32))
    want = jax_conv.int8_conv3x3(jnp.asarray(x), jnp.asarray(wq),
                                 jnp.asarray(ws), block_rows=br, block_o=128,
                                 interpret=True, **jkw)
    got = tc.int8_conv3x3_reference(
        T(x), T(np.asarray(wq).transpose(3, 0, 1, 2)), T(np.asarray(ws)),
        out_dtype=torch.float32, block_rows=br, **tkw)
    assert got.dtype == torch.float32 and got.shape == (b, h, w, o)
    wt = T(np.asarray(wq).transpose(3, 0, 1, 2))
    unrounded = tc.window_conv_reference(
        *tc.conv_windows_reference(tc.conv_prologue_reference(T(x)), br),
        wt, T(np.asarray(ws)), tkw["bias"], None, b)
    _assert_f32_within_pallas_bf16(got.numpy(), want, flips=prologue,
                                   unrounded=unrounded)


@pytest.mark.parametrize("packed", [True, False])
def test_int8_score_f32_reference_matches_pallas_at_sd15_width(packed):
    """8 heads: level 1's d=80 packed (the --quant all site, 256 tokens in
    place of 1024) and level 0's d=40 unpacked with a padded, masked kv."""
    heads = 8
    rng = np.random.default_rng(80 + packed)
    if packed:
        qkv = rng.standard_normal((2, 256, 3 * heads * 80)).astype(np.float32)
        want = jax_fa.flash_attention_qkv_packed_int8(
            jnp.asarray(qkv), heads, interpret=True)
        got = tfa.flash_attention_qkv_packed_int8_reference(T(qkv), heads)
        unrounded = tfa.int8_score_attention_f32(
            *T(qkv).split(heads * 80, dim=2), heads, 256)
    else:
        q = rng.standard_normal((2, 200, heads * 40)).astype(np.float32)
        k, v = (rng.standard_normal((2, 128, heads * 40)).astype(np.float32)
                for _ in range(2))
        want = jax_fa.flash_attention_hd_int8(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
            kv_len=100, interpret=True)
        got = tfa.flash_attention_hd_int8_reference(T(q), T(k), T(v), heads,
                                                    kv_len=100)
        unrounded = tfa.int8_score_attention_f32(T(q), T(k), T(v), heads, 100)
    assert got.dtype == torch.float32 and want.dtype == jnp.bfloat16
    _assert_f32_within_pallas_bf16(got.numpy(), want, flips=False,
                                   unrounded=unrounded, extra=1e-5)


# ------------------------------------------------------------------ model
def _conv_s1p1(x_shape, strides, padding, o=None) -> bool:
    return strides in ((1, 1), None) and padding in (1, ((1, 1), (1, 1)))


def test_f32_quant_all_unet_feeds_the_kernels_f32(monkeypatch):
    """One f32 ``--quant all`` UNet call on tiny_sd with every 3x3 conv and
    self-attention routed to the kernels: every int8 entry point receives
    f32 activations (x, residual) and returns f32, so nothing is converted
    to bf16 on the way into a kernel, and the output is f32 and finite."""
    tb = ModelBundle.random_init("tiny_sd", seed=0, dtype=torch.float32,
                                 device="cpu").quantized("all")
    monkeypatch.setattr(tq, "int8_conv3x3_supported", _conv_s1p1)
    monkeypatch.setattr(tfa, "FLASH_MIN_Q_LEN", 0)
    seen = {}

    def spy(name, fn):
        def run(*a, **k):
            x = a[0]
            res = k.get("residual")
            out = fn(*a, **k)
            seen.setdefault(name, set()).add(
                (x.dtype, None if res is None else res.dtype, out.dtype))
            return out
        return run

    monkeypatch.setattr(tq, "int8_matmul", spy("mm", tk.int8_matmul))
    monkeypatch.setattr(tq, "int8_conv3x3", spy("conv", tc.int8_conv3x3))
    monkeypatch.setattr(tu, "int8_ff_geglu", spy("ff", tk.int8_ff_geglu))
    monkeypatch.setattr(ta, "flash_attention_qkv_packed_int8",
                        spy("score", tfa.flash_attention_qkv_packed_int8))
    rng = np.random.default_rng(5)
    z = T(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    ctx = T(rng.standard_normal((2, 77, tb.unet.config.cross_attention_dim)
                                ).astype(np.float32))
    with torch.inference_mode():
        eps = tb.unet(z, torch.tensor(501), ctx)
    f32 = torch.float32
    assert sorted(seen) == ["conv", "ff", "mm", "score"]
    for name, combos in seen.items():
        for x_dt, res_dt, out_dt in combos:
            assert x_dt == out_dt == f32 and res_dt in (None, f32), name
    assert eps.dtype == f32 and bool(torch.isfinite(eps).all())


def test_f32_quant_all_int8_outputs_hold_bf16_values(monkeypatch):
    """Every int8 layer output of an f32 ``--quant all`` tiny_sd UNet call
    (every 3x3 conv and self-attention routed to the kernels) is
    bf16-representable, as JAX's bf16 kernel output cast to f32 is."""
    tb = ModelBundle.random_init("tiny_sd", seed=0, dtype=torch.float32,
                                 device="cpu").quantized("all")
    monkeypatch.setattr(tq, "int8_conv3x3_supported", _conv_s1p1)
    monkeypatch.setattr(tfa, "FLASH_MIN_Q_LEN", 0)
    outs = {}

    def spy(name, fn):
        def run(*a, **k):
            out = fn(*a, **k)
            outs.setdefault(name, []).append(out)
            return out
        return run

    monkeypatch.setattr(tq, "int8_matmul", spy("mm", tk.int8_matmul))
    monkeypatch.setattr(tq, "int8_conv3x3", spy("conv", tc.int8_conv3x3))
    monkeypatch.setattr(tu, "int8_ff_geglu", spy("ff", tk.int8_ff_geglu))
    monkeypatch.setattr(ta, "flash_attention_qkv_packed_int8",
                        spy("score", tfa.flash_attention_qkv_packed_int8))
    rng = np.random.default_rng(6)
    z = T(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    ctx = T(rng.standard_normal((2, 77, tb.unet.config.cross_attention_dim)
                                ).astype(np.float32))
    with torch.inference_mode():
        tb.unet(z, torch.tensor(301), ctx)
    assert sorted(outs) == ["conv", "ff", "mm", "score"]
    for name, ys in outs.items():
        for y in ys:
            assert y.dtype == torch.float32, name
            assert torch.equal(y, y.bfloat16().float()), name
