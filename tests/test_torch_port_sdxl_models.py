"""The port's SDXL modules against their Flax counterparts, on ``tiny_sdxl``.

``tiny_sdxl`` is a preset of both packages: a linear-projection UNet with
a 2-layer transformer stack at level 1, no attention at level 0, and the
``text_time`` added embedding; two CLIP text encoders (the second with
erf gelu and a projection).  Weights come from the JAX package's
``ModelBundle.random_init`` with every UNet and text-encoder leaf perturbed
(flax's norm scales 1 and biases 0 would hide a mix-up), through the weight
bridge with a strict state-dict load.  Inputs come from numpy and go to
both sides.

Tolerance: f32 on both sides, so only the summation order differs: 1e-4 x
max(1, max|ref|) for the UNet call (with and without cached cross k/v, with
the added conditioning) and both CLIPs' outputs.  The int8 forms are in
tests/test_torch_port_sdxl_int8.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgpp_tpu.engine import DiffusionEngine as JaxEngine
from cfgpp_tpu.engine import ModelBundle as JaxBundle
from cfgpp_tpu.models.unet import precompute_cross_kv as jax_cross_kv
from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
from cfgpp_tpu_torch.models.unet import precompute_cross_kv

EXACT_TOL = 1e-4      # f32 both sides: summation order only


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


def jax_tiny_sdxl():
    return jax_tiny_bundle("tiny_sdxl")


def jax_tiny_bundle(name):
    """The JAX ``name`` bundle (tiny_sdxl or tiny_sd) in f32, its weights
    made without compiling the JAX initializers (which cost more than most
    of these tests): the port's seeded ``random_init`` gives the
    diffusers-layout state dicts, every UNet and text-encoder leaf is
    perturbed (flax's norm scales 1 and biases 0 would hide a mix-up), and
    the JAX package's own checkpoint converter
    (``cfgpp_tpu/weights/convert.py``) makes the Flax trees, held leaf for
    leaf to the structure the JAX modules' ``init`` traces.  The port's
    bundles are then loaded from these trees through the weight bridge,
    strictly."""
    from cfgpp_tpu.configs import get_bundle_config
    from cfgpp_tpu.models import (AutoencoderKL, CLIPTextModel,
                                  UNet2DConditionModel)
    from cfgpp_tpu.weights.convert import (convert_clip_text, convert_unet,
                                           convert_vae)
    from cfgpp_tpu.weights.tokenizer import load_tokenizer

    cfg = get_bundle_config(name)
    src = ModelBundle.random_init(name, seed=0, dtype=torch.float32,
                                  device="cpu")
    rng = np.random.default_rng(1)

    def state(module, perturb):
        return {k: v.numpy() + (0.05 * rng.standard_normal(v.shape).astype(
            np.float32) if perturb else 0.0)
            for k, v in module.state_dict().items()}

    f32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
    unet = UNet2DConditionModel(cfg.unet, **f32)
    vae = AutoencoderKL(cfg.vae, **f32)
    text = CLIPTextModel(cfg.text_encoder)
    key, ids = jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32)
    unet_args = [jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                 jnp.zeros((1, 77, cfg.unet.cross_attention_dim))]
    if cfg.text_encoder_2 is not None:
        unet_args += [jnp.zeros((1, cfg.text_encoder_2.projection_dim)),
                      jnp.zeros((1, 6))]
    trees = {
        "unet_params": (convert_unet(state(src.unet, True)), jax.eval_shape(
            unet.init, key, *unet_args)),
        "vae_params": (convert_vae(state(src.vae, False)), jax.eval_shape(
            vae.init, key, jnp.zeros((1, 64, 64, 3)), key)),
        "text_params": (convert_clip_text(state(src.text_encoder, True)),
                        jax.eval_shape(text.init, key, ids)),
    }
    text2 = tok2 = None
    if cfg.text_encoder_2 is not None:
        text2 = CLIPTextModel(cfg.text_encoder_2)
        trees["text_params_2"] = (
            convert_clip_text(state(src.text_encoder_2, True)),
            jax.eval_shape(text2.init, key, ids))
        tok2 = load_tokenizer(None, vocab_size=1000, eos_token_id=999,
                              pad_token_id=0)
    for what, (tree, want) in trees.items():
        assert jax.tree.map(np.shape, tree) == jax.tree.map(
            lambda x: x.shape, want), what
    return JaxBundle(
        config=cfg, unet=unet, vae=vae, text_encoder=text,
        tokenizer=load_tokenizer(None, vocab_size=1000, eos_token_id=999),
        text_encoder_2=text2, tokenizer_2=tok2,
        **{k: jax.tree.map(np.float32, tree)
           for k, (tree, _) in trees.items()})


@pytest.fixture(scope="module")
def bundles():
    jb = jax_tiny_sdxl()
    tb = ModelBundle.from_flax("tiny_sdxl", jb.params(), dtype=torch.float32,
                               device="cpu")
    return jb, tb


@pytest.fixture(scope="module")
def jax_unet(bundles):
    """The JAX UNet call, jitted once for the module."""
    jb, _ = bundles
    return jax.jit(jb.unet.apply)


def unet_inputs(seed):
    """(sample, t, context, pooled text embeds, time ids) of a batch of 2."""
    rng = np.random.default_rng(seed)
    sample = rng.standard_normal((2, 16, 16, 4), np.float32)
    t = np.asarray([7, 421], np.int32)
    ctx = rng.standard_normal((2, 77, 80), np.float32)
    pooled = rng.standard_normal((2, 48), np.float32)
    time_ids = np.asarray([[64, 64, 0, 0, 64, 64],
                           [1024, 768, 16, 32, 512, 512]], np.float32)
    return sample, t, ctx, pooled, time_ids


@pytest.mark.parametrize("cached", [False, True])
def test_unet_added_conditioning(bundles, jax_unet, cached):
    jb, tb = bundles
    sample, t, ctx, pooled, ids = unet_inputs(4)
    want = jax_unet(jb.unet_params, *map(jnp.asarray, (
        sample, t, ctx, pooled, ids)))
    ctx_t = T(ctx)
    ckv = precompute_cross_kv(tb.unet, ctx_t) if cached else None
    got = tb.unet(T(sample), torch.from_numpy(t), ctx_t, T(pooled), T(ids),
                  cross_kv=ckv)
    assert got.dtype == torch.float32
    _assert_close(got, want, f"sdxl unet cached={cached}", EXACT_TOL)


def test_added_conditioning_moves_the_output(bundles):
    """The time ids and the pooled embeds reach the output (a UNet that
    dropped them would pass the comparison above only by accident)."""
    _, tb = bundles
    sample, t, ctx, pooled, ids = unet_inputs(4)
    base = tb.unet(T(sample), torch.from_numpy(t), T(ctx), T(pooled), T(ids))
    for what, p, i in (("time ids", pooled, ids + 8.0),
                       ("pooled", pooled + 1.0, ids)):
        moved = tb.unet(T(sample), torch.from_numpy(t), T(ctx), T(p), T(i))
        assert float((moved - base).abs().max()) > 1e-3, what


def test_unet_requires_added_conditioning(bundles):
    jb, tb = bundles
    sample, t, ctx, pooled, _ = unet_inputs(4)
    with pytest.raises(ValueError, match="added_text_embeds and added_time_ids"):
        jb.unet.apply(jb.unet_params, *map(jnp.asarray, (sample, t, ctx)))
    with pytest.raises(ValueError, match="added_text_embeds and added_time_ids"):
        tb.unet(T(sample), torch.from_numpy(t), T(ctx))
    with pytest.raises(ValueError, match="added_text_embeds and added_time_ids"):
        tb.unet(T(sample), torch.from_numpy(t), T(ctx), T(pooled))


def test_cross_kv_sites_match_jax(bundles):
    jb, tb = bundles
    ctx = np.random.default_rng(5).standard_normal((1, 77, 80), np.float32)
    want = jax_cross_kv(jb.unet_params, jb.config.unet, jnp.asarray(ctx),
                        dtype=jnp.float32)
    got = precompute_cross_kv(tb.unet, T(ctx))
    assert sorted(got) == sorted(want)
    assert sum(len(v) for v in got.values()) == 2 + 2 + 2 * 2  # down, mid, up
    for site in want:
        assert len(got[site]) == len(want[site])
        for (gk, gv), (wk, wv) in zip(got[site], want[site]):
            _assert_close(gk, wk, site, EXACT_TOL)
            _assert_close(gv, wv, site, EXACT_TOL)


@pytest.mark.parametrize("clip_skip", [None, 1])
@pytest.mark.parametrize("which", ["text_encoder", "text_encoder_2"])
def test_clip_outputs(bundles, which, clip_skip):
    jb, tb = bundles
    params = jb.text_params if which == "text_encoder" else jb.text_params_2
    tok = jb.tokenizer if which == "text_encoder" else jb.tokenizer_2
    ids = tok(["", "a photo of a cat", "snow leopard on a rock"])
    want = getattr(jb, which).apply(params, jnp.asarray(ids), clip_skip)
    got = getattr(tb, which)(torch.as_tensor(ids, dtype=torch.long), clip_skip)
    for field in ("last_hidden_state", "penultimate_hidden_state",
                  "pooled_output"):
        _assert_close(getattr(got, field), getattr(want, field),
                      f"{which} clip_skip={clip_skip} {field}", EXACT_TOL)


def test_tokenizers_match_jax(bundles):
    """tokenizer_2 pads with id 0, the first with EOS (``cfgpp_tpu/engine/
    bundle.py:112-119``)."""
    jb, tb = bundles
    texts = ["", "a photo of a cat"]
    np.testing.assert_array_equal(tb.tokenizer(texts), jb.tokenizer(texts))
    np.testing.assert_array_equal(tb.tokenizer_2(texts), jb.tokenizer_2(texts))
    assert tb.tokenizer_2(texts)[0, -1] == 0
    assert tb.tokenizer(texts)[0, -1] == 999


@pytest.mark.parametrize("clip_skip", [None, 1])
def test_text_embed_sdxl(bundles, clip_skip):
    """Both encoders' penultimate states concatenated, encoder 2's pooled."""
    jb, tb = bundles
    prompts, prompts_2 = ["a photo of a cat"], ["an oil painting"]
    je = JaxEngine(jb, "dpm++_2m_cfgpp", nfe=4)
    want = je._text_embed_sdxl(jb.text_params, jb.text_params_2,
                               je.tokenize(prompts), je.tokenize_2(prompts_2),
                               clip_skip)
    te = DiffusionEngine(tb, "dpm++_2m_cfgpp", nfe=4)
    got = te.text_embed(prompts, prompts_2, clip_skip)
    assert got[0].shape == (1, 77, 80) and got[1].shape == (1, 48)
    for g, w, what in zip(got, want, ("context", "pooled")):
        _assert_close(g, w, f"{what} clip_skip={clip_skip}", EXACT_TOL)
    if clip_skip is not None:   # the tap moved; the pooled output did not
        base = te.text_embed(prompts, prompts_2)
        assert float((got[0] - base[0]).abs().max()) > 1e-3
        torch.testing.assert_close(got[1], base[1], rtol=0, atol=0)


@pytest.mark.parametrize("sizes", [
    ((64, 64), (0, 0), (64, 64)),
    ((1024, 768), (16, 32), (512, 512)),
])
def test_make_add_time_ids(bundles, sizes):
    jb, tb = bundles
    want = JaxEngine(jb, "ddim", nfe=4).make_add_time_ids(3, *sizes)
    got = DiffusionEngine(tb, "ddim", nfe=4).make_add_time_ids(3, *sizes)
    assert got.dtype == np.float32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)


def test_make_add_time_ids_width_error(bundles):
    """The same message as JAX's when the add_embedding width disagrees."""
    jb, tb = bundles
    msgs = []
    for bundle, engine_cls in ((jb, JaxEngine), (tb, DiffusionEngine)):
        cfg = bundle.config
        bad = dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, projection_class_embeddings_input_dim=95))
        engine = engine_cls(bundle, "ddim", nfe=4)
        engine.bundle = dataclasses.replace(bundle, config=bad)
        with pytest.raises(ValueError, match="expects an added time") as e:
            engine.make_add_time_ids(1, (64, 64), (0, 0), (64, 64))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "length 95" in msgs[1] and "vector of 96" in msgs[1]


def test_random_init_draws_every_module():
    """random_init fills both encoders (the second after the first)."""
    b = ModelBundle.random_init("tiny_sdxl", seed=0, dtype=torch.float32,
                                device="cpu")
    again = ModelBundle.random_init("tiny_sdxl", seed=0, dtype=torch.float32,
                                    device="cpu")
    assert b.text_encoder_2 is not None and b.tokenizer_2 is not None
    for name in ("unet", "vae", "text_encoder", "text_encoder_2"):
        for (k, p), (_, q) in zip(getattr(b, name).state_dict().items(),
                                  getattr(again, name).state_dict().items()):
            assert torch.equal(p, q), (name, k)
    proj = b.text_encoder_2.text_projection.weight
    assert proj.shape == (48, 48) and float(proj.std()) > 0.05
    assert b.unet.add_embedding.linear_1.weight.shape == (
        b.config.unet.time_embed_dim, 8 * 6 + 48)
