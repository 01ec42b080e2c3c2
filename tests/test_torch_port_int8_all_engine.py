"""The port's ``--quant all`` UNet and engine against the JAX package's.

tiny_sd in f32, weights from the JAX package's ``ModelBundle.random_init``
(perturbed, so biases are not zero) through the weight bridge.  The
quantized state dict equals ``quantize_unet_params(mode="all")``'s (int8
values exactly, scales to rtol 1e-6).  The engines run ``ddim_cfg++`` at 4
NFE from the same injected zT, the JAX package on its TPU route emulated
(tests/torch_int8_route.py), with the real predicates and with the forced
ones (every 3x3 conv to the fused kernel, every attention to the flash
kernels): per-step z0t/zt and the image within 1e-2 x max(1, scale), the
bound of the ``--quant dense`` engine test.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgpp_tpu.engine import DiffusionEngine as JaxEngine
from cfgpp_tpu.engine import ModelBundle as JaxBundle
from cfgpp_tpu.weights.quantize import quantize_unet_params
from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
from cfgpp_tpu_torch.kernels import flash_attention as tfa
from cfgpp_tpu_torch.models import quant as tq
from cfgpp_tpu_torch.weights.bridge import diffusers_state_dict
from cfgpp_tpu_torch.weights.quantize import quantize_unet_
from tests.torch_int8_route import emulate_tpu_route


def _assert_close(got, want, what, tol=1e-2):
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


@pytest.fixture(scope="module")
def jax_bundle():
    jb = JaxBundle.random_init("tiny_sd", seed=0, dtype=jnp.float32,
                               param_dtype=jnp.float32)
    jb.unet_params = _perturbed(jb.unet_params, 3)
    return jb


def test_quantize_all_matches_jax(jax_bundle):
    """int8 values exactly, scales to rtol 1e-6, the same state-dict keys;
    every self-attention marked for the int8 score, no cross-attention."""
    want = diffusers_state_dict(
        quantize_unet_params(jax_bundle.unet_params, mode="all"))
    tb = ModelBundle.from_flax("tiny_sd", jax_bundle.params(),
                               dtype=torch.float32, device="cpu")
    unet = quantize_unet_(tb.unet, mode="all")
    got = unet.state_dict()
    assert sorted(got) == sorted(want)
    assert any(k.endswith("resnets.0.conv1.weight") and got[k].ndim == 4
               for k in got)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if w.dtype == torch.int8:
            assert torch.equal(g, w), key
        else:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0, msg=key)
    blocks = [t.transformer_blocks[0] for _, t in unet.cross_attention_sites()]
    assert all(b.attn1.int8_score and not b.attn2.int8_score for b in blocks)
    assert not isinstance(unet.down_blocks[0].downsamplers[0].conv,
                          tq.QuantConv)
    assert not isinstance(unet.conv_in, tq.QuantConv)


def test_from_flax_loads_quant_all_tree_strictly(jax_bundle):
    tb = ModelBundle.from_flax("tiny_sd", jax_bundle.quantized("all").params(),
                               dtype=torch.float32, device="cpu", quant="all")
    ref = ModelBundle.from_flax("tiny_sd", jax_bundle.params(),
                                dtype=torch.float32,
                                device="cpu").quantized("all")
    got, want = tb.unet.state_dict(), ref.unet.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=0)
    assert tb.unet.down_blocks[0].attentions[0].transformer_blocks[0] \
        .attn1.int8_score


# ------------------------------------------------------------------ engine
@pytest.mark.parametrize("force", [False, True], ids=["real", "forced"])
def test_quant_all_engine_matches_jax(jax_bundle, monkeypatch, force):
    jq = jax_bundle.quantized("all")
    tb = ModelBundle.from_flax("tiny_sd", jq.params(), dtype=torch.float32,
                               device="cpu", quant="all")
    emulate_tpu_route(monkeypatch, force=force)
    used = {"conv": 0, "int8_score": 0}
    conv, attn = tq.int8_conv3x3, tfa.int8_score_applies

    def count(key, fn):
        def spy(*a, **k):
            out = fn(*a, **k)
            used[key] += bool(out) if key == "int8_score" else 1
            return out
        return spy

    monkeypatch.setattr(tq, "int8_conv3x3", count("conv", conv))
    monkeypatch.setattr(importlib.import_module(
        "cfgpp_tpu_torch.models.attention"), "int8_score_applies",
        count("int8_score", attn))
    zT = np.random.default_rng(4).standard_normal((1, 8, 8, 4)).astype(np.float32)
    kw = dict(cfg_guidance=0.6, resolution=16, init_latent_override=zT,
              return_trajectory=True)
    prompt = ["", "a photo of a cat"]
    want_img, (want_z0, want_zt) = JaxEngine(jq, "ddim_cfg++", nfe=4).sample(
        prompt, **kw)
    img, (z0s, zts) = DiffusionEngine(tb, "ddim_cfg++", nfe=4).sample(
        prompt, **kw)
    assert (used["conv"] > 0) == force and (used["int8_score"] > 0) == force
    for i in range(4):
        _assert_close(z0s[i], want_z0[i], f"all z0t step {i}")
        _assert_close(zts[i], want_zt[i], f"all zt step {i}")
    _assert_close(img, want_img, "all image")
