"""The port's SD-2.x modules against their Flax counterparts.

Neither package has a tiny SD-2 preset, so each side builds one from its
own ``tiny_sd_config()`` with ``dataclasses.replace``: linear-projection
transformers, the erf-gelu CLIP and (for the engine tests) eps or v
prediction.  Weights come from the JAX package's ``ModelBundle.random_init``
with every leaf perturbed (flax's norm scales 1 and biases 0 would hide a
mix-up), through the weight bridge with a strict state-dict load.  Inputs
come from numpy and go to both sides.

Tolerances, each named at its comparison:
- exact, f32 on both sides (the linear-projection UNet call with and
  without cached cross k/v, the transformer alone, the gelu CLIP): 1e-4 x
  max(1, max|ref|); only the summation order differs.
- ``--quant dense`` / ``--quant all`` transformer against the JAX package
  on its TPU route emulated (tests/torch_int8_route.py: the Pallas kernels
  in interpret mode, proj_in on `int8_matmul`'s affine prologue): 1e-2 x
  max(1, max|ref|), the int8 engine tests' bound: a last-bit difference
  ahead of a quantize moves an int8 level.
- the whole ``--quant dense`` / ``--quant all`` UNet call on that route:
  4e-2 x max(1, max|ref|).  At these tiny widths one int8 level is a large
  step, and a whole call is as sensitive to the last bit as this: the
  port's own int8 call moves by 0.8e-2 (dense) and 1.5-2.5e-2 (all) x
  max|out| when its input changes by one f32 ulp (x (1 + 1e-7)), and the
  SD-1.5-layout UNet, whose int8 path the earlier tests hold through the
  engine, reads 0.6-1.6e-2 (dense) and 2.2-2.6e-2 (all) against the JAX
  route at the same inputs.  1e-2 would sit below the function's own
  last-bit noise; the engine and transformer tests keep 1e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfgpp_tpu.kernels.int8_matmul as jax_int8
from cfgpp_tpu.configs import tiny_sd_config as jax_tiny_sd_config
from cfgpp_tpu.engine import ModelBundle as JaxBundle
from cfgpp_tpu.models.unet import Transformer2DModel as JaxTransformer
from cfgpp_tpu.models.unet import precompute_cross_kv as jax_cross_kv
from cfgpp_tpu.weights.quantize import quantize_unet_params
from cfgpp_tpu_torch.configs import tiny_sd_config
from cfgpp_tpu_torch.engine import ModelBundle
from cfgpp_tpu_torch.models import quant as tq
from cfgpp_tpu_torch.models.unet import Transformer2DModel, precompute_cross_kv
from cfgpp_tpu_torch.weights.bridge import diffusers_state_dict
from cfgpp_tpu_torch.weights.quantize import quantized_structure_
from tests.torch_int8_route import emulate_tpu_route

EXACT_TOL = 1e-4      # f32 both sides: summation order only
INT8_TOL = 1e-2       # the int8 engine tests' bound (module doc)
INT8_CALL_TOL = 4e-2  # one whole int8 UNet call (module doc)


def sd2_config(base, prediction_type: str = "epsilon"):
    """A tiny SD-2.x-shaped bundle config from ``base()`` (either package's
    ``tiny_sd_config``): linear projections, erf-gelu CLIP."""
    cfg = base()
    return dataclasses.replace(
        cfg, name="tiny_sd2",
        unet=dataclasses.replace(cfg.unet, use_linear_projection=True,
                                 prediction_type=prediction_type),
        text_encoder=dataclasses.replace(cfg.text_encoder,
                                         hidden_act="gelu"))


def _assert_close(got, want, what, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= tol * max(1.0, scale), f"{what}: max err {err} (scale {scale})"


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32)), tree)


def T(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def bundles():
    jb = JaxBundle.random_init(sd2_config(jax_tiny_sd_config), seed=0,
                               dtype=jnp.float32, param_dtype=jnp.float32)
    jb.unet_params = _perturbed(jb.unet_params, 1)
    jb.text_params = _perturbed(jb.text_params, 3)
    tb = ModelBundle.from_flax(sd2_config(tiny_sd_config), jb.params(),
                               dtype=torch.float32, device="cpu")
    return jb, tb


def _unet_inputs(seed):
    cfg = jax_tiny_sd_config().unet
    rng = np.random.default_rng(seed)
    sample = rng.standard_normal((2, 16, 16, cfg.in_channels), np.float32)
    t = np.asarray([7, 421], np.int32)
    ctx = rng.standard_normal((2, 77, cfg.cross_attention_dim), np.float32)
    return sample, t, ctx


@pytest.mark.parametrize("cached", [False, True])
def test_unet_linear_projection(bundles, cached):
    jb, tb = bundles
    sample, t, ctx = _unet_inputs(4)
    want = jax.jit(jb.unet.apply)(jb.unet_params, jnp.asarray(sample),
                                  jnp.asarray(t), jnp.asarray(ctx))
    ctx_t = T(ctx)
    ckv = precompute_cross_kv(tb.unet, ctx_t) if cached else None
    got = tb.unet(T(sample), torch.from_numpy(t), ctx_t, cross_kv=ckv)
    assert got.dtype == torch.float32
    _assert_close(got, want, f"sd2 unet cached={cached}", EXACT_TOL)


def test_cross_kv_sites_match_jax(bundles):
    jb, tb = bundles
    ctx = np.random.default_rng(5).standard_normal((1, 77, 32), np.float32)
    want = jax_cross_kv(jb.unet_params, jb.config.unet, jnp.asarray(ctx),
                        dtype=jnp.float32)
    got = precompute_cross_kv(tb.unet, T(ctx))
    assert sorted(got) == sorted(want)
    for site in want:
        for (gk, gv), (wk, wv) in zip(got[site], want[site]):
            _assert_close(gk, wk, site, EXACT_TOL)
            _assert_close(gv, wv, site, EXACT_TOL)


def test_clip_gelu(bundles):
    jb, tb = bundles
    assert jb.config.text_encoder.hidden_act == "gelu"
    ids = jb.tokenizer(["", "a photo of a cat", "snow leopard on a rock"])
    want = jb.text_encoder.apply(jb.text_params, jnp.asarray(ids))
    got = tb.text_encoder(torch.as_tensor(ids, dtype=torch.long))
    for field in ("last_hidden_state", "penultimate_hidden_state",
                  "pooled_output"):
        _assert_close(getattr(got, field), getattr(want, field),
                      f"gelu clip {field}", EXACT_TOL)


# ------------------------------------------------------------ transformer
def _transformer(quant=False):
    kw = dict(groups=8, dtype=jnp.float32, param_dtype=jnp.float32)
    return JaxTransformer(2, 16, 1, True, quant=quant, **kw)


@pytest.fixture(scope="module")
def transformer_params():
    rng = np.random.default_rng(15)
    x = (2.0 * rng.standard_normal((2, 8, 8, 32)) + 0.5).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 48)).astype(np.float32)
    p = _perturbed(_transformer().init(jax.random.PRNGKey(1), jnp.asarray(x),
                                       jnp.asarray(ctx)), 16)
    return x, ctx, p


def test_transformer2d_linear_exact(transformer_params):
    x, ctx, p = transformer_params
    want = _transformer().apply(p, jnp.asarray(x), jnp.asarray(ctx))
    tt = Transformer2DModel(32, 2, 16, 1, 48, 8, linear=True)
    tt.load_state_dict(diffusers_state_dict(p))
    tt.requires_grad_(False)
    got = tt(T(x).permute(0, 3, 1, 2), T(ctx)).permute(0, 2, 3, 1)
    _assert_close(got, want, "linear transformer2d", EXACT_TOL)


@pytest.mark.parametrize("mode", ["dense", "all"])
def test_transformer2d_linear_quant_matches_jax_route(transformer_params,
                                                      monkeypatch, mode):
    """proj_in as one `int8_matmul` with the GroupNorm as its affine
    prologue (eps 1e-6, no SiLU) on both sides; proj_out with the input
    fused as its residual."""
    x, ctx, p = transformer_params
    pq = quantize_unet_params(p, mode=mode)
    emulate_tpu_route(monkeypatch)
    jax_calls, port_calls = [], []
    jax_mm, port_mm = jax_int8.int8_matmul, tq.int8_matmul
    monkeypatch.setattr(jax_int8, "int8_matmul", lambda *a, **k: (
        jax_calls.append(sorted(k)) or jax_mm(*a, **k)))
    monkeypatch.setattr(tq, "int8_matmul", lambda *a, **k: (
        port_calls.append(sorted(k)) or port_mm(*a, **k)))
    want = _transformer(True if mode == "all" else mode).apply(
        pq, jnp.asarray(x), jnp.asarray(ctx))
    tt = quantized_structure_(
        Transformer2DModel(32, 2, 16, 1, 48, 8, linear=True), mode)
    tt.load_state_dict(diffusers_state_dict(pq))
    tt.requires_grad_(False)
    assert isinstance(tt.proj_in, tq.QuantLinear)
    assert isinstance(tt.proj_out, tq.QuantLinear)
    got = tt(T(x).permute(0, 3, 1, 2), T(ctx)).permute(0, 2, 3, 1)
    for calls in (jax_calls, port_calls):
        affine = [c for c in calls if "affine_scale" in c]
        assert len(affine) == 1 and "affine_bias" in affine[0]
    _assert_close(got, want, f"linear transformer2d --quant {mode}", INT8_TOL)


def test_proj_in_affine_is_the_groupnorm(transformer_params):
    """The affine prologue normalises as the exact transformer's GroupNorm
    (eps 1e-6, the affine applied to the unnormalised input)."""
    x, ctx, p = transformer_params
    tt = Transformer2DModel(32, 2, 16, 1, 48, 8, linear=True)
    tt.load_state_dict(diffusers_state_dict(p))
    xc = T(x).permute(0, 3, 1, 2)
    n = tt.norm
    s, b = tq.groupnorm_silu_coeffs(xc.permute(0, 2, 3, 1), n.weight, n.bias,
                                    n.num_groups, eps=n.eps)
    want = n(xc).permute(0, 2, 3, 1)
    got = xc.permute(0, 2, 3, 1) * s[:, None, None] + b[:, None, None]
    assert n.eps == 1e-6
    _assert_close(got.detach(), want.detach(), "affine GroupNorm", EXACT_TOL)


# ------------------------------------------------------------ int8 UNet
@pytest.mark.parametrize("mode", ["dense", "all"])
def test_from_flax_loads_quantized_tree_strictly(bundles, mode):
    """A JAX ``quantized(mode)`` tree of a linear-projection UNet loads
    strictly, into the layers `quantize_unet_` makes from the float tree."""
    jb, _ = bundles
    cfg = sd2_config(tiny_sd_config)
    tb = ModelBundle.from_flax(cfg, jb.quantized(mode).params(),
                               dtype=torch.float32, device="cpu", quant=mode)
    ref = ModelBundle.from_flax(cfg, jb.params(), dtype=torch.float32,
                                device="cpu").quantized(mode)
    got, want = tb.unet.state_dict(), ref.unet.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=0)
    tr = tb.unet.down_blocks[0].attentions[0]
    assert isinstance(tr.proj_in, tq.QuantLinear)
    assert tr.proj_in.weight.shape == (32, 32)
    assert got["down_blocks.0.attentions.0.proj_in.weight"].dtype == torch.int8


@pytest.mark.parametrize("mode", ["dense", "all"])
@pytest.mark.parametrize("cached", [False, True])
def test_quantized_unet_matches_jax_route(bundles, monkeypatch, mode, cached):
    jb, _ = bundles
    jq = jb.quantized(mode)
    tb = ModelBundle.from_flax(sd2_config(tiny_sd_config), jq.params(),
                               dtype=torch.float32, device="cpu", quant=mode)
    emulate_tpu_route(monkeypatch)
    sample, t, ctx = _unet_inputs(6)
    want = jq.unet.apply(jq.unet_params, jnp.asarray(sample), jnp.asarray(t),
                         jnp.asarray(ctx))
    ctx_t = T(ctx)
    ckv = precompute_cross_kv(tb.unet, ctx_t) if cached else None
    got = tb.unet(T(sample), torch.from_numpy(t), ctx_t, cross_kv=ckv)
    _assert_close(got, want, f"sd2 unet --quant {mode} cached={cached}",
                  INT8_CALL_TOL)

