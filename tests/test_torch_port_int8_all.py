"""The port's ``--quant all`` path against the JAX package's.

Kernels: the plain versions of the Hopper kernels (what the wrappers compute
on a CPU tensor) against the Pallas kernels in interpret mode.
`int8_conv3x3_reference` follows the Pallas kernel's recipe, so without a
prologue it is bit-equal to it; with the GroupNorm + SiLU prologue the two
sigmoids may round differently, and a value on a quantization boundary moves
one int8 level: the JAX test's own rule then holds (atol 0.01, under 0.1% of
the elements differing).  The int8-score attention's plain version quantizes
q and k exactly as ``_kernel_single_int8`` does; the Pallas kernel writes
bf16, and so does the port's plain version (its f32 output holds bf16
values): equal, except where the port's f32 value before that write lies
within 1e-5 (the f32 tolerance of the bf16 attention tests: exp2 and the
sums differ in their last bits) of a bf16 rounding tie, where the two may
be one bf16 ulp apart.

Numerics chosen on the TPU: `scale_window_rows`, `int8_conv3x3_supported`
and `int8_score_applies` equal the JAX decisions at every SD-1.5 and SDXL
site and on a grid of other shapes; the attention decision is read off the
JAX route itself (which kernel body it traces).

The quant-all resnet and upsampler run against the JAX modules on the
JAX package's TPU route emulated (tests/torch_int8_route.py), with the real
predicates and with the "forced" ones (every 3x3 conv to the fused kernel):
1e-2 x max(1, scale), the bound of the ``--quant dense`` engine test.  The
UNet and the engine are in test_torch_port_int8_all_engine.py.
"""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgpp_tpu.models import attention as jax_attention
from cfgpp_tpu.models import quant as jax_quant
from cfgpp_tpu.models.unet import ResnetBlock2D as JaxResnet
from cfgpp_tpu.models.unet import Upsample2D as JaxUpsample
from cfgpp_tpu.weights.quantize import quantize_unet_params
from cfgpp_tpu_torch.kernels import flash_attention as tfa
from cfgpp_tpu_torch.kernels import int8_conv as tc
from cfgpp_tpu_torch.models import quant as tq
from cfgpp_tpu_torch.models.unet import ResnetBlock2D, Upsample2D
from cfgpp_tpu_torch.weights.bridge import diffusers_state_dict
from cfgpp_tpu_torch.weights.quantize import quantized_structure_
from tests.torch_int8_route import assert_pallas_bf16_write, emulate_tpu_route

jax_fa = importlib.import_module("cfgpp_tpu.kernels.flash_attention")
jax_conv = importlib.import_module("cfgpp_tpu.kernels.int8_conv")
REPO = Path(__file__).resolve().parents[1]


def T(a):
    return torch.from_numpy(np.array(a, order="C"))


def _assert_close(got, want, what, tol=1e-2):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= tol * max(1.0, scale), f"{what}: max err {err} (scale {scale})"


# ------------------------------------------------------------ int8_conv3x3
@pytest.mark.parametrize("b,h,w,c,o,br,bias,prologue", [
    (1, 8, 8, 128, 128, 4, True, False),     # several windows: halo crossing
    (2, 8, 16, 128, 256, 8, True, False),    # batch 2: windows never mix samples
    (1, 16, 8, 256, 128, 4, False, False),   # no bias
    (2, 4, 8, 128, 128, 4, True, False),     # a window is the whole sample
    (2, 16, 32, 128, 128, None, True, False),  # both sides pick br
    (2, 8, 16, 128, 128, 4, True, True),     # GroupNorm + SiLU prologue, residual
    (2, 16, 32, 128, 128, None, False, True),
])
def test_int8_conv3x3_reference_matches_pallas(b, h, w, c, o, br, bias,
                                               prologue):
    rng = np.random.default_rng(h * w + c + o + prologue)
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    wq, ws = jax_quant.quantize_conv_kernel_int8(
        rng.normal(0, 0.05, (3, 3, c, o)).astype(np.float32))
    jkw, tkw = {}, {}

    def add(name, arr):
        jkw[name], tkw[name] = jnp.asarray(arr), T(np.asarray(arr, np.float32))

    if bias:
        add("bias", rng.normal(0, 0.1, (o,)).astype(np.float32))
    if prologue:
        add("gn_scale", rng.normal(1, 0.2, (b, c)).astype(np.float32))
        add("gn_bias", rng.normal(0, 0.3, (b, c)).astype(np.float32))
        add("residual", np.asarray(jnp.asarray(
            rng.normal(0, 1, (b, h, w, o)), jnp.bfloat16), np.float32))
    if br is not None:
        jkw.update(block_rows=br, block_o=128)
    want = np.asarray(jax_conv.int8_conv3x3(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws), interpret=True,
        **jkw), np.float32)
    got = tc.int8_conv3x3_reference(
        T(x), T(np.asarray(wq).transpose(3, 0, 1, 2)), T(np.asarray(ws)),
        block_rows=br, **tkw)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, w, o)
    got = got.float().numpy()
    if not prologue:
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_allclose(got, want, atol=0.01, rtol=0)
    assert (got != want).mean() < 1e-3


_SD15_CONVS = [  # (h, w, c, o) of every SD-1.5 3x3 conv at 512^2 and 256^2
    (s // f, s // f, c, o) for s in (64, 32) for f, c, o in (
        (1, 4, 320), (1, 320, 320), (2, 320, 640), (2, 640, 640),
        (4, 640, 1280), (4, 1280, 1280), (8, 1280, 1280), (8, 2560, 1280),
        (4, 2560, 1280), (4, 1920, 1280), (2, 1280, 1280), (2, 1920, 640),
        (2, 1280, 640), (2, 960, 640), (2, 640, 640), (1, 640, 640),
        (1, 960, 320), (1, 640, 320), (1, 320, 320), (1, 320, 4))]
_SDXL_CONVS = [  # SDXL at 1024^2: 128^2 / 64^2 / 32^2 latents
    (128, 128, 4, 320), (128, 128, 320, 320), (64, 64, 320, 640),
    (64, 64, 640, 640), (32, 32, 640, 1280), (32, 32, 1280, 1280),
    (32, 32, 2560, 1280), (32, 32, 1920, 1280), (64, 64, 1280, 1280),
    (64, 64, 1920, 640), (64, 64, 1280, 640), (64, 64, 960, 640),
    (128, 128, 640, 640), (128, 128, 960, 320), (128, 128, 640, 320),
    (128, 128, 320, 4)]
_GRID = [(h, w, c, o) for h in (8, 16, 24, 48, 96) for w in (32, 64, 96)
         for c in (128, 384, 1024) for o in (128, 640, 2048)]


@pytest.mark.parametrize("shapes", ["sd15", "sdxl", "grid"])
def test_conv_numerics_choices_match_jax(shapes):
    """``br`` and the routing predicate are the JAX functions' at every
    shape: they decide the numbers, not only the speed."""
    cases = {"sd15": _SD15_CONVS, "sdxl": _SDXL_CONVS, "grid": _GRID}[shapes]
    for h, w, c, o in cases:
        assert tc.scale_window_rows(h, w, c, o) == \
            jax_conv._pick_blocks(h, w, c, o)[0], (h, w, c, o)
        for b in (1, 2):
            for strides, pad in (((1, 1), 1), ((2, 2), 1), ((1, 1), 0),
                                 ((1, 1), ((1, 1), (1, 1)))):
                for oo in (o, None):
                    assert tc.int8_conv3x3_supported(
                        (b, h, w, c), strides, pad, oo) == \
                        jax_conv.int8_conv3x3_supported(
                            (b, h, w, c), strides, pad, oo), (h, w, c, o)


# --------------------------------------------------- int8-score attention
def _jnp_quantize_qk(q, k, heads):
    """q/k int8 and scales as ``_kernel_single_int8`` computes them (its
    lines for one head, over every head)."""
    b, nq, hd = q.shape
    d = hd // heads
    qj = jnp.asarray(q).reshape(b, nq, heads, d)
    kj = jnp.asarray(k).reshape(b, k.shape[1], heads, d)
    sq = jnp.maximum(jnp.max(jnp.abs(qj), axis=3, keepdims=True),
                     1e-6) * (1.0 / 127.0)
    qq = jnp.clip(jnp.round(qj * (1.0 / sq)), -127.0, 127.0).astype(jnp.int8)
    sk = jnp.maximum(jnp.max(jnp.abs(kj), axis=(1, 3), keepdims=True),
                     1e-6) * (1.0 / 127.0)
    kq = jnp.clip(jnp.round(kj * (1.0 / sk)), -127.0, 127.0).astype(jnp.int8)
    return (np.asarray(qq).reshape(b, nq, hd), np.asarray(sq)[..., 0],
            np.asarray(kq).reshape(b, -1, hd), np.asarray(sk)[:, 0, :, 0])


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_int8_score_reference_matches_pallas(d, packed):
    heads = 2
    rng = np.random.default_rng(d + packed)
    if packed:
        n = 256                  # the in-place packed route needs n % 128 == 0
        qkv = rng.standard_normal((2, n, 3 * heads * d)).astype(np.float32)
        want = jax_fa.flash_attention_qkv_packed_int8(
            jnp.asarray(qkv), heads, interpret=True)
        got = tfa.flash_attention_qkv_packed_int8_reference(
            T(qkv), heads, out_dtype=torch.float32)
        q, k, v = np.split(qkv, 3, axis=2)
        kv_len = n
    else:                        # ragged q, k/v padded to 128 rows, 100 valid
        q = rng.standard_normal((2, 200, heads * d)).astype(np.float32)
        k, v = (rng.standard_normal((2, 128, heads * d)).astype(np.float32)
                for _ in range(2))
        k[:, 100:] *= 3.0        # padded rows still set the k scale
        want = jax_fa.flash_attention_hd_int8(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
            kv_len=100, interpret=True)
        got = tfa.flash_attention_hd_int8_reference(
            T(q), T(k), T(v), heads, kv_len=100, out_dtype=torch.float32)
        kv_len = 100
    assert want.dtype == jnp.bfloat16 and got.shape == want.shape
    assert_pallas_bf16_write(
        got.numpy(), tfa.int8_score_attention_f32(T(q), T(k), T(v), heads,
                                                  kv_len), want, 1e-5)
    for g, w in zip(tfa.quantize_qk_reference(T(q), T(k), heads),
                    _jnp_quantize_qk(q, k, heads)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.float32))


_ATTN_SITES = [
    # SD-1.5 512^2: levels 0/1/2 and the mid block (8 heads)
    (4096, 8, 40), (1024, 8, 80), (256, 8, 160), (64, 8, 160),
    # SD-1.5 256^2
    (1024, 8, 40), (256, 8, 80), (16, 8, 160),
    # SDXL 1024^2: level 1 (10 heads) and level 2 / mid (20 heads), d=64
    (4096, 10, 64), (1024, 20, 64),
    # others: the pack read in place at a ragged n, long sequences, d % 8
    (1000, 2, 64), (1152, 2, 64), (2048, 8, 40), (2048, 4, 64),
    (8192, 8, 40), (1024, 2, 16), (1024, 4, 20), (3072, 8, 80),
]


def _jax_takes_int8_score(monkeypatch, n, heads, d) -> bool:
    """Whether the JAX TPU route traces ``_kernel_single_int8`` for the
    quantized self-attention (jit removed, so nothing is cached)."""
    seen = []
    real = jax_fa._kernel_single_int8
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax_fa, "_kernel_single_int8",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    for name in ("flash_attention_hd", "flash_attention_hd_int8",
                 "flash_attention_qkv_packed",
                 "flash_attention_qkv_packed_int8"):
        fn = getattr(jax_fa, name)
        monkeypatch.setattr(jax_fa, name, getattr(fn, "__wrapped__", fn))
    jax.eval_shape(
        lambda x: jax_attention.attention_qkv_packed(x, heads,
                                                     int8_score=True),
        jax.ShapeDtypeStruct((2, n, 3 * heads * d), jnp.bfloat16))
    return bool(seen)


@pytest.mark.parametrize("n,heads,d", _ATTN_SITES)
def test_int8_score_applies_matches_jax_route(monkeypatch, n, heads, d):
    assert tfa.int8_score_applies(n, heads, d) == _jax_takes_int8_score(
        monkeypatch, n, heads, d)


def test_int8_score_sites_at_sd15_512():
    """At SD-1.5 512^2 only level 1 (1024 tokens, d=80) takes the int8
    score: the sites the chip run counts."""
    assert [tfa.int8_score_applies(n, 8, d) for n, _, d in _ATTN_SITES[:4]] \
        == [False, True, False, False]


# ---------------------------------------------------------------- recipes
@pytest.mark.parametrize("shape,temb", [((2, 4, 8, 64), True),
                                        ((2, 4, 8, 64), False),
                                        ((1, 8, 8, 96), True)])
def test_groupnorm_silu_coeffs_match_jax(shape, temb):
    rng = np.random.default_rng(sum(shape) + temb)
    c = shape[-1]
    x = (2.0 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    be = (0.1 * rng.standard_normal(c)).astype(np.float32)
    t = rng.standard_normal((shape[0], c)).astype(np.float32) if temb else None
    got = tq.groupnorm_silu_coeffs(T(x), T(g), T(be), 8,
                                   temb=None if t is None else T(t))
    want = jax_quant.groupnorm_silu_coeffs(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(be), 8,
        temb=None if t is None else jnp.asarray(t))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("k", [1, 3])
def test_quantize_conv_kernel_matches_jax(k):
    w = (0.05 * np.random.default_rng(k).standard_normal(
        (k, k, 48, 40))).astype(np.float32)
    jq, js = jax_quant.quantize_conv_kernel_int8(w)
    tqw, ts = tq.quantize_conv_kernel_int8(T(w.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(tqw.numpy(), np.asarray(jq).transpose(3, 0, 1, 2))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


# ----------------------------------------------------------------- modules
def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32)), tree)


@pytest.mark.parametrize("force", [False, True], ids=["real", "forced"])
@pytest.mark.parametrize("module", ["resnet", "resnet_shortcut", "upsample"])
def test_quant_all_modules_match_jax(monkeypatch, module, force):
    rng = np.random.default_rng(21)
    kw = dict(dtype=jnp.float32, param_dtype=jnp.float32)
    cin, cout = (32, 64) if module == "resnet_shortcut" else (32, 32)
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    temb = rng.standard_normal((2, 64)).astype(np.float32)
    if module == "upsample":
        args, jmod = (jnp.asarray(x),), JaxUpsample(cin, **kw)
        tmod = Upsample2D(cin)
    else:
        args = (jnp.asarray(x), jnp.asarray(temb))
        jmod = JaxResnet(cout, groups=8, **kw)
        tmod = ResnetBlock2D(cin, cout, 64, 8, 1e-5)
    pq = quantize_unet_params(
        _perturbed(jmod.init(jax.random.PRNGKey(2), *args), 22), mode="all")
    quantized_structure_(tmod, "all")
    tmod.load_state_dict(diffusers_state_dict(pq))
    tmod.requires_grad_(False)
    emulate_tpu_route(monkeypatch, force=force)
    calls = []
    monkeypatch.setattr(tq, "int8_conv3x3",
                        lambda *a, **k: calls.append(1) or tc.int8_conv3x3(
                            *a, **k))
    want = jmod.clone(quant=True).apply(pq, *args)
    xt = T(x).permute(0, 3, 1, 2)
    got = (tmod(xt) if module == "upsample"
           else tmod(xt, T(temb))).permute(0, 2, 3, 1)
    assert bool(calls) == force      # the route the predicate chose
    _assert_close(got, want, f"{module} ({'forced' if force else 'real'})")


# ---------------------------------------------------------- wrappers, CLI
def test_wrappers_on_cpu_use_reference_without_launch():
    rng = np.random.default_rng(5)
    x = T(rng.standard_normal((1, 8, 8, 32)).astype(np.float32)).bfloat16()
    wq = torch.randint(-127, 128, (16, 3, 3, 32), dtype=torch.int8)
    ws = torch.full((16,), 0.01)
    qkv = T(rng.standard_normal((2, 64, 96)).astype(np.float32)).bfloat16()
    tc.reset_launches()
    tfa.reset_launches()
    assert torch.equal(tc.int8_conv3x3(x, wq, ws),
                       tc.int8_conv3x3_reference(x, wq, ws))
    assert torch.equal(tfa.flash_attention_qkv_packed_int8(qkv, 2),
                       tfa.flash_attention_qkv_packed_int8_reference(qkv, 2))
    q, k, v = qkv.split(32, dim=2)
    assert torch.equal(tfa.flash_attention_hd_int8(q, k, v, 2, kv_len=50),
                       tfa.flash_attention_hd_int8_reference(q, k, v, 2, 50))
    assert tc.conv_launches == tfa.int8_launches == \
        tfa.packed_int8_launches == 0


@pytest.mark.parametrize("launcher", ["int8_conv3x3_stages",
                                      "flash_attention_hd_int8_stages",
                                      "flash_attention_qkv_packed_int8_stages"])
def test_int8_all_stage_launchers_have_no_plain_route(launcher):
    """The stage launchers exist to check the kernels on the card; on a CPU
    tensor they raise and count nothing."""
    x = torch.zeros(1, 8, 32, 32, dtype=torch.bfloat16)
    qkv = torch.zeros(1, 64, 3 * 80, dtype=torch.bfloat16)
    call = {
        "int8_conv3x3_stages": lambda: tc.int8_conv3x3_stages(
            x, torch.zeros(16, 3, 3, 32, dtype=torch.int8), torch.ones(16)),
        "flash_attention_hd_int8_stages": lambda: tfa.
        flash_attention_hd_int8_stages(*qkv.split(80, dim=2), 2),
        "flash_attention_qkv_packed_int8_stages": lambda: tfa.
        flash_attention_qkv_packed_int8_stages(qkv, 2)}[launcher]
    tc.reset_launches()
    tfa.reset_launches()
    with pytest.raises(ValueError, match="no kernel for cpu"):
        call()
    assert tc.conv_launches == tfa.int8_launches == \
        tfa.packed_int8_launches == 0


def test_cli_quant_all_runs_without_jax(tmp_path):
    """``--quant all`` on tiny_sd through the CLI, in a fresh interpreter:
    the 3x3 int8 convs run (their dequantized-weight route: tiny widths are
    below the fused kernel's predicate), the int8 projections run, and
    neither jax nor flax is imported."""
    code = (
        "import sys\n"
        "from cfgpp_tpu_torch.cli.text_to_img import main\n"
        "import cfgpp_tpu_torch.kernels.int8_matmul as q\n"
        "import cfgpp_tpu_torch.models.quant as m\n"
        "calls = {'mm': 0, 'conv': 0}\n"
        "ref, conv = q.int8_matmul_reference, m.QuantConv._dequant_conv\n"
        "def mm(*a, **k):\n"
        "    calls['mm'] += 1\n"
        "    return ref(*a, **k)\n"
        "def dq(*a, **k):\n"
        "    calls['conv'] += 1\n"
        "    return conv(*a, **k)\n"
        "q.int8_matmul_reference, m.QuantConv._dequant_conv = mm, dq\n"
        "main(['--model', 'tiny_sd', '--device', 'cpu', '--dtype', 'float32',\n"
        "      '--method', 'ddim_cfg++', '--cfg_guidance', '0.6', '--NFE', '2',\n"
        "      '--resolution', '16', '--prompt', 'a cat', '--quant', 'all',\n"
        f"      '--workdir', {str(tmp_path)!r}])\n"
        "assert calls['mm'] and calls['conv'], calls\n"
        "bad = sorted(mod for mod in sys.modules\n"
        "             if mod.split('.')[0] in ('cfgpp_tpu', 'jax', 'jaxlib',\n"
        "                                 'flax'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "result" / "generated.png").is_file()
