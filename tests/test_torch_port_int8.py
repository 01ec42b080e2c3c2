"""The port's int8 W8A8 path against the JAX package's.

Kernels: the plain versions of the Hopper kernels (what the wrappers
compute on a CPU tensor) against the Pallas kernels run in interpret mode,
as tests/test_int8_matmul.py runs them.  Both write bf16 and quantize the
same way, so they agree to one bf16 ulp of each output element: the f32
epilogue is the same arithmetic, and the JAX side may round a
multiply-add once.  A LayerNorm prologue sums in another order, which can
move one int8 level; at most 0.1% of the elements may then differ by more,
each within 2e-2 x max|ref|.  Where no norm precedes the quantize, the int8
activations are bit-equal.

Weights: the port's quantizer against ``quantize_unet_params(mode="dense")``.

Modules (tiny widths, f32): the quantized `Attention`, `FeedForward`,
`BasicTransformerBlock` and `Transformer2DModel` against the Flax modules on
two routes.  ``cpu``: the JAX package's CPU route (layernorm_ref and its
W8A8 dense recipe in f32), with its int8 outputs rounded to bf16 where the
TPU kernels write them and its activations quantized as the kernels do,
``x * (1/sx)`` (tests/torch_int8_route.py: `round_cpu_route_writes`):
2e-4 x max(1, scale), as the exact modules are held.  The attention
sublayers read bit-equal, the FF one element one bf16 ulp apart.  The
whole block is held to that bound with the JAX side's LayerNorm given the
port's values (bit-equal too), and to 1e-2 x max(1, scale) with its own:
the two LayerNorms sum 32 f32 terms in different orders, one f32 ulp
apart moves an int8 level, the bf16 write turns that
into a one-ulp step in a projection's output, and the next sublayers carry
it on (measured 4.3e-3 x scale, 29 of 4096 elements differ).  Its 1x1
QuantConv is a dequantized-weight conv instead (quant.py:126-144), so
`Transformer2DModel` runs only on ``tpu``: the TPU route emulated
(``jax.default_backend`` returns "tpu" and the int8 kernels run in
interpret mode), the port's own code on the other side.  There each
projection's output is rounded to bf16 on both sides, a one-ulp difference
there can move an int8 level downstream, and the tolerance is 1e-2 x max(1,
scale), the bound past which the int8 engine's gap would be a fault
(measured 4.3e-3 x scale on the whole block).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfgpp_tpu.kernels.int8_matmul as jax_int8
from cfgpp_tpu.kernels.flash_attention import \
    flash_attention_qkv_packed as jax_packed
from cfgpp_tpu.models import quant as jax_quant
from cfgpp_tpu.models.attention import Attention as JaxAttention
from cfgpp_tpu.models.unet import BasicTransformerBlock as JaxBlock
from cfgpp_tpu.models.unet import FeedForward as JaxFeedForward
from cfgpp_tpu.models.unet import Transformer2DModel as JaxTransformer
from cfgpp_tpu.engine import ModelBundle as JaxBundle
from cfgpp_tpu.weights.quantize import quantize_unet_params
from cfgpp_tpu_torch.engine import ModelBundle
from cfgpp_tpu_torch.kernels import flash_attention as fa
from cfgpp_tpu_torch.kernels import int8_matmul as tk
from cfgpp_tpu_torch.models import quant as tq
from cfgpp_tpu_torch.models.unet import (BasicTransformerBlock,
                                         Transformer2DModel)
from cfgpp_tpu_torch.weights.bridge import diffusers_state_dict
from cfgpp_tpu_torch.weights.quantize import (quantize_unet_,
                                              quantized_structure_)
from tests.torch_int8_route import emulate_tpu_route, round_cpu_route_writes


def T(a):
    return torch.from_numpy(np.array(a, order="C"))


def _weights(rng, k, n):
    """int8 [K, N] (JAX layout) and its f32 [N] scale."""
    wq, ws = jax_quant.quantize_kernel_int8(
        (0.05 * rng.standard_normal((k, n))).astype(np.float32))
    return np.asarray(wq), np.asarray(ws)


def _assert_bf16_close(got, want, ln: bool):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -100))) - 7)
    off = err > ulp
    if not ln:
        assert not off.any(), f"{off.sum()} elements beyond one bf16 ulp"
        return
    assert off.mean() <= 1e-3, f"{off.sum()} of {off.size} elements differ"
    assert err.max() <= 2e-2 * np.abs(want).max()


# ------------------------------------------------------------------- kernels
@pytest.mark.parametrize("case", ["plain", "bias", "ln", "affine", "residual",
                                  "ln_residual", "batch_dims", "ragged_m",
                                  "bf16_x"])
def test_int8_matmul_reference_matches_pallas(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    shape = {"batch_dims": (2, 3, 24), "ragged_m": (100,)}.get(case, (2, 64))
    k, n = 320, 256
    x = (2.0 * rng.standard_normal(shape + (k,)) + 0.3).astype(np.float32)
    wq, ws = _weights(rng, k, n)
    jkw, tkw = {}, {}

    def add(name, arr):
        jkw[name], tkw[name] = jnp.asarray(arr), T(arr)

    if case != "plain":
        add("bias", (0.1 * rng.standard_normal(n)).astype(np.float32))
    if case in ("ln", "ln_residual"):
        add("ln_scale", (1 + 0.1 * rng.standard_normal(k)).astype(np.float32))
        add("ln_bias", (0.1 * rng.standard_normal(k)).astype(np.float32))
    if case == "affine":
        add("affine_scale", rng.standard_normal((2, k)).astype(np.float32))
        add("affine_bias", rng.standard_normal((2, k)).astype(np.float32))
        jkw["block_m"] = 32          # whole row blocks per sample: fused path
    if case in ("residual", "ln_residual"):
        add("residual", rng.standard_normal(shape + (n,)).astype(np.float32))
    xj = jnp.asarray(x, jnp.bfloat16 if case == "bf16_x" else jnp.float32)
    want = jax_int8.int8_matmul(xj, jnp.asarray(wq), jnp.asarray(ws),
                                interpret=True, **jkw)
    xt = T(np.asarray(xj, np.float32)).to(
        torch.bfloat16 if case == "bf16_x" else torch.float32)
    got = tk.int8_matmul_reference(xt, T(wq.T), T(ws), **tkw)
    assert got.dtype == torch.bfloat16 and got.shape == shape + (n,)
    _assert_bf16_close(got.float(), want, ln=case.startswith("ln"))


@pytest.mark.parametrize("shape,dtype", [((64,), jnp.float32),
                                         ((100,), jnp.bfloat16),
                                         ((2, 3, 8), jnp.float32)])
def test_int8_activations_bit_equal(shape, dtype):
    """With identity weights (scale 1) the output is ``xq * sx`` rounded to
    bf16, and ``round(out / sx)`` recovers xq exactly (|xq| <= 127 < 2^8):
    the Pallas kernel's int8 activations equal `quantize_rows`'s."""
    k = 64
    x = np.random.default_rng(7).standard_normal(shape + (k,)).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    eye = np.eye(k, dtype=np.int8)
    out = np.asarray(jax_int8.int8_matmul(xj, jnp.asarray(eye),
                                          jnp.ones((k,), jnp.float32),
                                          interpret=True), np.float32)
    xq, sx = tk.quantize_rows(T(np.asarray(xj, np.float32)))
    np.testing.assert_array_equal(np.round(out / sx.numpy()), xq.numpy())


@pytest.mark.parametrize("ln,bias,residual", [(False, False, False),
                                              (True, True, True),
                                              (True, False, True),
                                              (False, True, False)])
def test_int8_ff_geglu_reference_matches_pallas(ln, bias, residual):
    rng = np.random.default_rng(int(ln) + 2 * int(bias) + 4 * int(residual))
    m, k, n = 96, 320, 640
    x = rng.standard_normal((m, k)).astype(np.float32)
    w1q, w1s = _weights(rng, k, 2 * n)
    w2q, w2s = _weights(rng, n, k)
    b1 = (0.1 * rng.standard_normal(2 * n)).astype(np.float32) if bias else None
    b2 = (0.1 * rng.standard_normal(k)).astype(np.float32) if bias else None
    jkw, tkw = {}, {}
    if ln:
        g = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
        be = (0.1 * rng.standard_normal(k)).astype(np.float32)
        jkw.update(ln_scale=jnp.asarray(g), ln_bias=jnp.asarray(be))
        tkw.update(ln_scale=T(g), ln_bias=T(be))
    if residual:
        r = rng.standard_normal((m, k)).astype(np.float32)
        jkw["residual"], tkw["residual"] = jnp.asarray(r), T(r)
    opt = (lambda a: None if a is None else jnp.asarray(a))
    want = jax_int8.int8_ff_geglu(
        jnp.asarray(x), jnp.asarray(w1q), jnp.asarray(w1s), opt(b1),
        jnp.asarray(w2q), jnp.asarray(w2s), opt(b2), gelu="erf",
        interpret=True, **jkw)
    topt = (lambda a: None if a is None else T(a))
    got = tk.int8_ff_geglu_reference(T(x), T(w1q.T), T(w1s), topt(b1),
                                     T(w2q.T), T(w2s), topt(b2), **tkw)
    assert got.dtype == torch.bfloat16 and got.shape == (m, k)
    # the hidden state passes through erf (exact here, a 1.5e-7 polynomial in
    # the TPU kernel) and a second quantize: held like an LN prologue
    _assert_bf16_close(got.float(), want, ln=True)


@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_flash_qkv_packed_reference_matches_pallas(d):
    """f32 on both sides: 1e-5 abs, as the unpacked kernel is held."""
    h, n = 2, 200                       # ragged N (not a multiple of 128)
    qkv = np.random.default_rng(d).standard_normal((2, n, 3 * h * d)).astype(
        np.float32)
    want = np.asarray(jax_packed(jnp.asarray(qkv), h, interpret=True))
    got = fa.flash_attention_qkv_packed_reference(T(qkv), h)
    assert got.shape == (2, n, h * d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_wrappers_on_cpu_use_reference_without_launch():
    rng = np.random.default_rng(11)
    x = T(rng.standard_normal((3, 5, 64)).astype(np.float32)).bfloat16()
    wq, ws = _weights(rng, 64, 128)
    w2q, w2s = _weights(rng, 64, 64)
    tk.reset_launches()
    got = tk.int8_matmul(x, T(wq.T), T(ws))
    assert torch.equal(got, tk.int8_matmul_reference(x, T(wq.T), T(ws)))
    args = (x, T(wq.T), T(ws), None, T(w2q.T), T(w2s), None)
    assert torch.equal(tk.int8_ff_geglu(*args),
                       tk.int8_ff_geglu_reference(*args))
    assert tk.matmul_launches == tk.ff_launches == 0


@pytest.mark.parametrize("launcher", ["int8_matmul_stages",
                                      "int8_ff_geglu_stages"])
def test_stage_launchers_have_no_plain_route(launcher):
    """The stage launchers exist to check the kernels; on a CPU tensor they
    raise instead of computing the plain version, and count nothing."""
    rng = np.random.default_rng(13)
    x = T(rng.standard_normal((4, 64)).astype(np.float32)).bfloat16()
    wq, ws = _weights(rng, 64, 128)
    w2q, w2s = _weights(rng, 64, 64)
    args = {"int8_matmul_stages": (x, T(wq.T), T(ws)),
            "int8_ff_geglu_stages": (x, T(wq.T), T(ws), None, T(w2q.T),
                                     T(w2s), None)}[launcher]
    tk.reset_launches()
    with pytest.raises(ValueError, match="no kernel for cpu"):
        getattr(tk, launcher)(*args)
    assert tk.matmul_launches == tk.ff_launches == 0


def test_wrappers_reject_other_devices_and_bad_shapes():
    meta = torch.empty(4, 64, device="meta")
    w = torch.zeros(32, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="no kernel"):
        tk.int8_matmul(meta, w, torch.ones(32))
    with pytest.raises(ValueError, match="do not agree"):
        tk.int8_matmul(torch.zeros(4, 63), w, torch.ones(32))
    with pytest.raises(ValueError, match="int8"):
        tk.int8_matmul(torch.zeros(4, 64), w.float(), torch.ones(32))
    with pytest.raises(ValueError, match="exclusive"):
        tk.int8_matmul(torch.zeros(1, 4, 64), w, torch.ones(32),
                       ln_scale=torch.ones(64), ln_bias=torch.zeros(64),
                       affine_scale=torch.ones(1, 64),
                       affine_bias=torch.zeros(1, 64))
    with pytest.raises(ValueError, match="value . gate"):
        tk.int8_ff_geglu(torch.zeros(4, 64), w, torch.ones(32), None,
                         torch.zeros(64, 32, dtype=torch.int8),
                         torch.ones(64), None)


def test_quant_recipes_match_jax():
    """The port's plain recipes outside the kernels equal the JAX functions:
    the weight quantizers (2-D and conv: the same int8 values, scales to one
    ulp), `layernorm_ref` and `groupnorm_silu_coeffs` (f32, summation order
    only).  The activation quantize is held through `quantize_rows` against
    the Pallas kernels above."""
    rng = np.random.default_rng(12)
    w = (0.05 * rng.standard_normal((1280, 96))).astype(np.float32)
    jwq, jws = jax_quant.quantize_kernel_int8(w)
    twq, tws = tq.quantize_kernel_int8(T(w.T))
    np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq).T)
    # XLA may turn the division by 127 into a multiply: one ulp
    np.testing.assert_allclose(tws.numpy(), np.asarray(jws), rtol=1e-6)
    wc = (0.05 * rng.standard_normal((3, 3, 64, 48))).astype(np.float32)
    jcq, jcs = jax_quant.quantize_conv_kernel_int8(wc)
    tcq, tcs = tq.quantize_conv_kernel_int8(T(wc.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(tcq.numpy(),
                                  np.asarray(jcq).transpose(3, 0, 1, 2))
    np.testing.assert_allclose(tcs.numpy(), np.asarray(jcs), rtol=1e-6)
    x = rng.standard_normal((7, 1280)).astype(np.float32)
    g, be = rng.standard_normal(1280).astype(np.float32), np.zeros(1280, np.float32)
    np.testing.assert_allclose(
        tq.layernorm_ref(T(x), T(g), T(be)).numpy(),
        np.asarray(jax_quant.layernorm_ref(jnp.asarray(x), jnp.asarray(g),
                                           jnp.asarray(be))),
        rtol=0, atol=1e-5)
    xi = (2.0 * rng.standard_normal((2, 4, 8, 64)) + 0.5).astype(np.float32)
    t = rng.standard_normal((2, 64)).astype(np.float32)
    gm, bt = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32), \
        (0.1 * rng.standard_normal(64)).astype(np.float32)
    for got, want in zip(
            tq.groupnorm_silu_coeffs(T(xi), T(gm), T(bt), 8, temb=T(t)),
            jax_quant.groupnorm_silu_coeffs(jnp.asarray(xi), jnp.asarray(gm),
                                            jnp.asarray(bt), 8,
                                            temb=jnp.asarray(t))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------------------------------- weights
def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32)), tree)


@pytest.fixture(scope="module")
def jax_bundle():
    jb = JaxBundle.random_init("tiny_sd", seed=0, dtype=jnp.float32,
                               param_dtype=jnp.float32)
    jb.unet_params = _perturbed(jb.unet_params, 1)
    return jb


def test_quantize_matches_jax(jax_bundle):
    """int8 values exactly, scales to rtol 1e-6, the same state-dict keys."""
    want = diffusers_state_dict(
        quantize_unet_params(jax_bundle.unet_params, mode="dense"))
    tb = ModelBundle.from_flax("tiny_sd", jax_bundle.params(),
                               dtype=torch.float32, device="cpu")
    got = quantize_unet_(tb.unet).state_dict()
    assert sorted(got) == sorted(want)
    assert any(k.endswith("attn1.to_qkv.weight") for k in got)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if w.dtype == torch.int8:
            assert torch.equal(g, w), key
        else:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0, msg=key)


def test_from_flax_loads_quantized_tree_strictly(jax_bundle):
    jq = jax_bundle.quantized("dense")
    tb = ModelBundle.from_flax("tiny_sd", jq.params(), dtype=torch.float32,
                               device="cpu", quant="dense")
    ref = ModelBundle.from_flax("tiny_sd", jax_bundle.params(),
                                dtype=torch.float32, device="cpu").quantized()
    got, want = tb.unet.state_dict(), ref.unet.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=0)


def test_bf16_bundle_keeps_scales_and_biases_f32():
    exact = ModelBundle.random_init("tiny_sd", seed=0, dtype=torch.bfloat16,
                                    device="cpu")
    bundle = exact.quantized()
    quant = [m for m in bundle.unet.modules()
             if isinstance(m, (tq.QuantLinear, tq.QuantConv))]
    sites = len(list(bundle.unet.cross_attention_sites()))
    assert len(quant) == 10 * sites     # proj_in/out + 8 per (one) block
    for m in quant:
        assert m.weight.dtype == torch.int8
        assert m.weight_scale.dtype == torch.float32
        assert m.bias is None or m.bias.dtype == torch.float32
    assert bundle.unet.conv_in.weight.dtype == torch.bfloat16
    assert not any(isinstance(m, (tq.QuantLinear, tq.QuantConv))
                   for m in exact.unet.modules())   # the exact UNet stays
    img = bundle.unet(torch.zeros(1, 8, 8, 4), torch.tensor(5),
                      torch.zeros(1, 77, 32))
    assert img.dtype == torch.float32 and torch.isfinite(img).all()


def test_unported_modes_raise():
    """An unknown mode raises; a 3x3 `QuantConv` builds (int8 [O, 3, 3, I]),
    other kernel sizes raise."""
    unet = ModelBundle.random_init("tiny_sd", seed=0, dtype=torch.float32,
                                   device="cpu").unet
    with pytest.raises(ValueError, match="mode"):
        quantize_unet_(unet, mode="int4")
    conv = tq.QuantConv(8, 16, kernel_size=3)
    assert conv.weight.shape == (16, 3, 3, 8) and conv.weight.dtype == torch.int8
    with pytest.raises(ValueError, match="1x1 or 3x3"):
        tq.QuantConv(8, 8, kernel_size=5)


# ------------------------------------------------------------------- modules
@pytest.fixture
def route(request, monkeypatch):
    if request.param == "tpu":
        emulate_tpu_route(monkeypatch)
    else:
        round_cpu_route_writes(monkeypatch)
    return request.param


def _assert_close(got, want, what, route, tol=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    tol = tol or (2e-4 if route == "cpu" else 1e-2)
    assert err <= tol * max(1.0, scale), f"{what}: max err {err} (scale {scale})"


def _port_layernorm(x, scale, bias, eps=1e-5):
    """The port's plain LayerNorm in place of ``layernorm_ref`` on the JAX
    side: the same formula, its f32 sums in torch's order."""
    return jnp.asarray(tk.layernorm_ref(T(x), T(scale), T(bias), eps).numpy())


@pytest.fixture(scope="module")
def block_params():
    """A perturbed exact block tree and its ``quantize_unet_params`` form
    (attn1 packed into to_qkv)."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 64, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 48)).astype(np.float32)
    jb = JaxBlock(2, 16, dtype=jnp.float32, param_dtype=jnp.float32)
    p = _perturbed(jb.init(jax.random.PRNGKey(0), jnp.asarray(x),
                           jnp.asarray(ctx)), 14)
    return x, ctx, quantize_unet_params(p, mode="dense")


@pytest.mark.parametrize("route", ["cpu", "tpu"], indirect=True)
@pytest.mark.parametrize("module", ["attn_self", "attn_cross", "ff", "block"])
def test_quant_block_modules_match_jax(block_params, route, module,
                                       monkeypatch):
    x, ctx, pq = block_params
    tb = quantized_structure_(BasicTransformerBlock(32, 2, 16, 48))
    tb.load_state_dict(diffusers_state_dict(pq))
    tb.requires_grad_(False)
    p = pq["params"]
    xt, ct = T(x), T(ctx)
    kw = dict(dtype=jnp.float32, param_dtype=jnp.float32, quant="dense")
    attn = functools.partial(JaxAttention, num_heads=2, head_dim=16,
                             out_dim=32, **kw)
    jx, jc = jnp.asarray(x), jnp.asarray(ctx)

    def ln(name):
        return (p[name]["scale"], p[name]["bias"])

    if module == "attn_self":
        want = attn().apply({"params": p["attn1"]}, jx, ln=ln("norm1"),
                            residual=jx)
        got = tb.attn1(xt, ln=tb.norm1, residual=xt)
    elif module == "attn_cross":
        want = attn().apply({"params": p["attn2"]}, jx, context=jc,
                            ln=ln("norm2"), residual=jx)
        got = tb.attn2(xt, ct, ln=tb.norm2, residual=xt)
    elif module == "ff":
        want = JaxFeedForward(32, **kw).apply({"params": p["ff"]}, jx,
                                              ln=ln("norm3"), residual=jx)
        got = tb.ff(xt, ln=tb.norm3, residual=xt)
    else:
        want = JaxBlock(2, 16, **kw).apply(pq, jx, jc)
        got = tb(xt, ct)
        if route == "cpu":
            _assert_close(got, want, "block (cpu route)", route, tol=1e-2)
            monkeypatch.setattr(jax_quant, "layernorm_ref", _port_layernorm)
            want = JaxBlock(2, 16, **kw).apply(pq, jx, jc)
    assert got.dtype == torch.float32
    _assert_close(got, want, f"{module} ({route} route)", route)


@pytest.mark.parametrize("route", ["tpu"], indirect=True)
def test_quant_transformer2d_matches_jax(route):
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 48)).astype(np.float32)
    kw = dict(groups=8, dtype=jnp.float32, param_dtype=jnp.float32)
    p = _perturbed(JaxTransformer(2, 16, 1, False, **kw).init(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(ctx)), 16)
    pq = quantize_unet_params(p, mode="dense")
    want = JaxTransformer(2, 16, 1, False, quant="dense", **kw).apply(
        pq, jnp.asarray(x), jnp.asarray(ctx))
    tt = quantized_structure_(Transformer2DModel(32, 2, 16, 1, 48, 8))
    tt.load_state_dict(diffusers_state_dict(pq))
    tt.requires_grad_(False)
    got = tt(T(x).permute(0, 3, 1, 2), T(ctx)).permute(0, 2, 3, 1)
    _assert_close(got, want, "transformer2d (tpu route)", route)
