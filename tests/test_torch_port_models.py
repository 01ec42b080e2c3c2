"""The port's CLIP, UNet and VAE against their Flax counterparts.

Weights come from the JAX package's ``ModelBundle.random_init("tiny_sd",
float32)``, with every leaf perturbed (flax initializes norm scales to 1 and
biases to 0, which would hide a scale/shift or bias mix-up), and go to the
port through `cfgpp_tpu_torch.weights.bridge` with a strict state-dict load.
Inputs come from numpy and go to both sides.

Tolerance: 2e-4 x max(1, max|out|) in f32, as tests/test_torch_parity.py:85
holds its torch reference against the same Flax modules: both sides are
f32 throughout and differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgpp_tpu.configs import tiny_sd_config
from cfgpp_tpu.engine import ModelBundle as JaxBundle
from cfgpp_tpu.models.attention import Attention as JaxAttention
from cfgpp_tpu.models.unet import precompute_cross_kv as jax_cross_kv
from cfgpp_tpu.models.vae import VAEAttentionBlock as JaxVAEAttention
from cfgpp_tpu_torch.engine import ModelBundle
from cfgpp_tpu_torch.models.attention import Attention
from cfgpp_tpu_torch.models.unet import precompute_cross_kv
from cfgpp_tpu_torch.models.vae import VAEAttentionBlock
from cfgpp_tpu_torch.weights.bridge import diffusers_state_dict


def _assert_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= 2e-4 * max(1.0, scale), f"{what}: max err {err} (scale {scale})"


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32)), tree)


@pytest.fixture(scope="module")
def bundles():
    jb = JaxBundle.random_init("tiny_sd", seed=0, dtype=jnp.float32,
                               param_dtype=jnp.float32)
    jb.unet_params = _perturbed(jb.unet_params, 1)
    jb.vae_params = _perturbed(jb.vae_params, 2)
    jb.text_params = _perturbed(jb.text_params, 3)
    tb = ModelBundle.from_flax("tiny_sd", jb.params(), dtype=torch.float32,
                               device="cpu")
    return jb, tb


def test_clip_text_model(bundles):
    jb, tb = bundles
    ids = jb.tokenizer(["", "a photo of a cat", "snow leopard on a rock"])
    want = jb.text_encoder.apply(jb.text_params, jnp.asarray(ids))
    got = tb.text_encoder(torch.as_tensor(ids, dtype=torch.long))
    for field in ("last_hidden_state", "penultimate_hidden_state",
                  "pooled_output"):
        _assert_close(getattr(got, field), getattr(want, field), field)


@pytest.mark.parametrize("cached", [False, True])
def test_unet(bundles, cached):
    jb, tb = bundles
    cfg = tiny_sd_config().unet
    rng = np.random.default_rng(4)
    sample = rng.standard_normal((2, 16, 16, cfg.in_channels), np.float32)
    t = np.asarray([7, 421], np.int32)
    ctx = rng.standard_normal((2, 77, cfg.cross_attention_dim), np.float32)
    want = jax.jit(jb.unet.apply)(jb.unet_params, jnp.asarray(sample),
                                  jnp.asarray(t), jnp.asarray(ctx))
    ctx_t = torch.from_numpy(ctx)
    ckv = precompute_cross_kv(tb.unet, ctx_t) if cached else None
    got = tb.unet(torch.from_numpy(sample), torch.from_numpy(t), ctx_t,
                  cross_kv=ckv)
    assert got.dtype == torch.float32
    _assert_close(got, want, f"unet cached={cached}")


def test_cross_kv_sites_match_jax(bundles):
    jb, tb = bundles
    ctx = np.random.default_rng(5).standard_normal((1, 77, 32), np.float32)
    want = jax_cross_kv(jb.unet_params, jb.config.unet, jnp.asarray(ctx),
                        dtype=jnp.float32)
    got = precompute_cross_kv(tb.unet, torch.from_numpy(ctx))
    assert sorted(got) == sorted(want)
    for site in want:
        for (gk, gv), (wk, wv) in zip(got[site], want[site]):
            _assert_close(gk, wk, site)
            _assert_close(gv, wv, site)


def test_quantized_cross_kv_sites_match_jax(bundles, monkeypatch):
    """precompute_cross_kv of the int8 UNet against the JAX package's CPU
    route (quant_dense_apply, W8A8 in f32 like the port's plain version),
    its outputs rounded to bf16 as the TPU kernel and the port write them."""
    from cfgpp_tpu.weights.quantize import quantize_unet_params
    from tests.torch_int8_route import round_cpu_route_writes

    jb, tb = bundles
    round_cpu_route_writes(monkeypatch)
    ctx = np.random.default_rng(12).standard_normal((2, 77, 32), np.float32)
    want = jax_cross_kv(quantize_unet_params(jb.unet_params, mode="dense"),
                        jb.config.unet, jnp.asarray(ctx), quant="dense",
                        dtype=jnp.float32)
    got = precompute_cross_kv(tb.quantized().unet, torch.from_numpy(ctx))
    assert sorted(got) == sorted(want)
    for site in want:
        for (gk, gv), (wk, wv) in zip(got[site], want[site]):
            _assert_close(gk, wk, site)
            _assert_close(gv, wv, site)


def test_vae_decode(bundles):
    jb, tb = bundles
    z = np.random.default_rng(6).standard_normal((1, 8, 8, 4), np.float32)
    want = jax.jit(lambda p, x: jb.vae.apply(p, x, method=jb.vae.decode))(
        jb.vae_params, jnp.asarray(z))
    got = tb.vae.decode(torch.from_numpy(z))
    assert got.shape == (1, 16, 16, 3)
    _assert_close(got, want, "vae decode")


def test_vae_encode(bundles):
    jb, tb = bundles
    img = np.random.default_rng(7).standard_normal((1, 16, 16, 3), np.float32)
    want = jb.vae.apply(jb.vae_params, jnp.asarray(img), method=jb.vae.encode)
    got = tb.vae.encode(torch.from_numpy(img))
    for g, w, what in zip(got, want, ("mean", "logvar")):
        _assert_close(g, w, what)


@pytest.mark.parametrize("mode", ["self", "cross", "cross_padded_kv_len"])
def test_attention_module(mode):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 24, 32), np.float32)
    ctx = rng.standard_normal((2, 77, 48), np.float32)
    jmod = JaxAttention(num_heads=2, head_dim=16, out_dim=32,
                        dtype=jnp.float32, param_dtype=jnp.float32)
    init_args = (jnp.asarray(x),) if mode == "self" else (
        jnp.asarray(x), jnp.asarray(ctx))
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), *init_args), 9)
    tmod = Attention(32, 2, 16, context_dim=None if mode == "self" else 48)
    tmod.load_state_dict(diffusers_state_dict(params))
    tmod.requires_grad_(False)
    if mode == "self":
        want = jmod.apply(params, jnp.asarray(x))
        got = tmod(torch.from_numpy(x))
    else:
        want = jmod.apply(params, jnp.asarray(x), jnp.asarray(ctx))
        c = torch.from_numpy(ctx)
        if mode == "cross":
            got = tmod(torch.from_numpy(x), c)
        else:   # k/v from a context padded to 128 rows, masked back to 77
            k, v = tmod.kv(torch.nn.functional.pad(c, (0, 0, 0, 51)))
            got = tmod(torch.from_numpy(x), kv_len=77, cached_kv=(k, v))
    _assert_close(got, want, f"attention {mode}")


def test_vae_attention_block():
    x = np.random.default_rng(10).standard_normal((1, 6, 6, 32), np.float32)
    jmod = JaxVAEAttention(channels=32, groups=8)
    params = _perturbed(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)), 11)
    tmod = VAEAttentionBlock(32, 8)
    tmod.load_state_dict(diffusers_state_dict(params))
    tmod.requires_grad_(False)
    want = jmod.apply(params, jnp.asarray(x))
    got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _assert_close(got, want, "vae attention block")
