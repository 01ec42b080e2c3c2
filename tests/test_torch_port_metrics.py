"""The port's metric towers against the JAX package's, on the same weights.

Random torch-layout state dicts (``cfgpp_tpu_torch.tools.metric_synth``:
pytorch-fid's InceptionV3 keys with BatchNorm, torchvision's VGG16 and the
LPIPS heads, a combined transformers CLIPModel) go through each package's
converter, and the JAX trees also through the port's bridge
(``cfgpp_tpu_torch.weights.bridge``), so each test runs the port twice.
Held within rel-L2 1e-5 of the JAX outputs (the JAX tower read 3e-8 to
1.8e-7 against a plain torch reference in ``tests/test_inception.py``):

* InceptionV3 features with the in-model resize off at 2x96^2 and on at
  2x64^2;
* LPIPS at 2x64^2 (and LPIPS(a, a) exactly 0 in the port);
* a tiny CLIP image tower (2 layers, width 64, patch 14 at 28^2) and the
  CLIP text tower with a projection;
* ``preprocess_for_clip`` at 224 (unchanged, exactly as JAX) and resized
  up and down, and its refusal of non-square images; the CLIP-score text
  features' refusal of the hash tokenizer.

The exported names of ``metrics`` are the JAX package's.
"""

import dataclasses
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfgpp_tpu.metrics as jax_metrics
from cfgpp_tpu.configs import CLIPTextConfig as JaxCLIPTextConfig
from cfgpp_tpu.metrics.inception import InceptionV3Features as JaxInception
from cfgpp_tpu.metrics.inception import convert_inception as jax_convert_inception
from cfgpp_tpu.metrics.lpips import LPIPS as JaxLPIPS
from cfgpp_tpu.metrics.lpips import convert_vgg16_lpips as jax_convert_lpips
from cfgpp_tpu.models.clip import CLIPTextModel as JaxCLIPText
from cfgpp_tpu.models.clip_vision import CLIPVisionConfig as JaxVisionConfig
from cfgpp_tpu.models.clip_vision import CLIPVisionModel as JaxVision
from cfgpp_tpu.models.clip_vision import preprocess_for_clip as jax_preprocess
from cfgpp_tpu.weights.convert import convert_clip_text, convert_clip_vision
from cfgpp_tpu_torch import metrics
from cfgpp_tpu_torch.configs import CLIPTextConfig
from cfgpp_tpu_torch.metrics.inception import InceptionV3Features, convert_inception
from cfgpp_tpu_torch.metrics.lpips import LPIPS, convert_vgg16_lpips
from cfgpp_tpu_torch.models.clip import CLIPTextModel
from cfgpp_tpu_torch.models.clip_vision import (CLIPVisionConfig,
                                                CLIPVisionModel,
                                                preprocess_for_clip)
from cfgpp_tpu_torch.tools import metric_synth
from cfgpp_tpu_torch.weights import bridge
from cfgpp_tpu_torch.weights.convert import (clip_text_from_hf,
                                             clip_vision_from_hf, load_module_)
from cfgpp_tpu_torch.weights.safetensors_io import save_file

REL_TOL = 1e-5
TINY_VISION = dict(hidden_size=64, num_layers=2, num_heads=2,
                   intermediate_size=128, image_size=28, patch_size=14,
                   projection_dim=32)
TINY_TEXT = dict(hidden_size=64, num_layers=2, num_heads=2,
                 intermediate_size=128, projection_dim=32)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for this module: the test workers share the cores,
    and oversubscribed intra-op threads stall each op at its barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _numpy(state):
    return {k: v.numpy() for k, v in state.items()}


def _port(module, state, what):
    load_module_(module, state, what)
    return module.eval()


@pytest.fixture(scope="module")
def inception_state():
    return metric_synth.inception_state(0)


@pytest.fixture(scope="module", params=[(False, 96), (True, 64)],
                ids=["resize_off_96", "resize_on_64"])
def inception_case(request, inception_state):
    """(resize, input, JAX params, JAX features), the JAX side run once."""
    resize, hw = request.param
    x = np.random.default_rng(0).uniform(size=(2, hw, hw, 3)).astype(np.float32)
    params = jax_convert_inception(_numpy(inception_state))
    want = np.asarray(JaxInception(resize_input=resize).apply(
        params, jnp.asarray(x)))
    return resize, x, params, want


@pytest.mark.parametrize("route", ["converter", "bridge"])
def test_inception_matches_jax(inception_state, inception_case, route):
    resize, x, params, want = inception_case
    state = (convert_inception(inception_state) if route == "converter"
             else bridge.tower_state_dict(params))
    model = _port(InceptionV3Features(resize_input=resize), state, "inception")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert np.abs(want).max() > 1e-3          # the random tower is not dead
    assert _rel(got, want) <= REL_TOL


def test_inception_converter_skips_fc(inception_state):
    got = convert_inception(inception_state)
    assert "fc.weight" in inception_state
    assert not any(k.startswith(("fc", "AuxLogits")) for k in got)
    assert len(got) == 2 * 94


@pytest.fixture(scope="module")
def lpips_case():
    """(weights, inputs, JAX params, JAX LPIPS), the JAX side run once."""
    vgg, lin = metric_synth.vgg16_state(0), metric_synth.lpips_heads_state(1)
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), -1, 1).astype(np.float32)
    params = jax_convert_lpips(_numpy(vgg), _numpy(lin))
    want = np.asarray(JaxLPIPS().apply(params, jnp.asarray(a), jnp.asarray(b)))
    return vgg, lin, a, b, params, want


@pytest.mark.parametrize("route", ["converter", "bridge"])
def test_lpips_matches_jax(lpips_case, route):
    vgg, lin, a, b, params, want = lpips_case
    state = (convert_vgg16_lpips(vgg, lin) if route == "converter"
             else bridge.tower_state_dict(params))
    model = _port(LPIPS(), state, "lpips")
    with torch.no_grad():
        got = model(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        same = model(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    assert got.shape == want.shape == (2,) and (want > 0).all()
    assert _rel(got, want) <= REL_TOL
    np.testing.assert_array_equal(same, np.zeros(2, np.float32))


@pytest.fixture(scope="module")
def tiny_clip_state():
    return metric_synth.clip_model_state(
        0, CLIPTextConfig(**TINY_TEXT), CLIPVisionConfig(**TINY_VISION))


@pytest.mark.parametrize("route", ["converter", "bridge"])
def test_clip_vision_matches_jax(tiny_clip_state, route):
    px = np.random.default_rng(0).normal(size=(2, 28, 28, 3)).astype(np.float32)
    params = convert_clip_vision(_numpy(tiny_clip_state))
    want = np.asarray(JaxVision(JaxVisionConfig(**TINY_VISION)).apply(
        params, jnp.asarray(px)))
    state = (clip_vision_from_hf(tiny_clip_state) if route == "converter"
             else bridge.clip_vision_state_dict(params))
    model = _port(CLIPVisionModel(CLIPVisionConfig(**TINY_VISION)), state,
                  "clip vision")
    with torch.no_grad():
        got = model(torch.from_numpy(px)).numpy()
    assert got.shape == want.shape == (2, 32)
    assert _rel(got, want) <= REL_TOL


def test_clip_vision_loader_refuses_other_keys(tiny_clip_state):
    with pytest.raises(KeyError, match="unhandled CLIP vision key"):
        clip_vision_from_hf(dict(tiny_clip_state, **{"foo.weight": torch.zeros(1)}))
    text_only = {k: v for k, v in tiny_clip_state.items()
                 if not k.startswith(("vision_model", "visual_projection"))}
    with pytest.raises(KeyError, match="no vision_model"):
        clip_vision_from_hf(text_only)


@pytest.mark.parametrize("route", ["converter", "bridge"])
def test_clip_text_projection_matches_jax(tiny_clip_state, tmp_path, route):
    from cfgpp_tpu_torch.weights.tokenizer import load_tokenizer
    tok = load_tokenizer(str(metric_synth.write_clip_vocab(tmp_path)))
    ids = tok(["a photo of the cat", "an astronaut riding a horse on mars"])
    assert ids[0, 0] == metric_synth.BOS_ID
    jcfg = JaxCLIPTextConfig(**TINY_TEXT)
    params = convert_clip_text(_numpy(tiny_clip_state))
    want = np.asarray(JaxCLIPText(jcfg).apply(params, jnp.asarray(ids))
                      .pooled_output)
    state = (clip_text_from_hf(tiny_clip_state) if route == "converter"
             else bridge.clip_text_state_dict(params))
    model = _port(CLIPTextModel(CLIPTextConfig(**TINY_TEXT)), state, "clip")
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long()).pooled_output.numpy()
    assert got.shape == want.shape == (2, 32)
    assert _rel(got, want) <= REL_TOL


@pytest.mark.parametrize("n_in", [224, 300, 100])
def test_preprocess_for_clip_matches_jax(n_in):
    x = np.random.default_rng(0).uniform(size=(2, n_in, n_in, 3)).astype(np.float32)
    want = np.asarray(jax_preprocess(jnp.asarray(x)))
    got = preprocess_for_clip(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 224, 224, 3)
    if n_in == 224:          # jax.image.resize to the same size: unchanged
        np.testing.assert_array_equal(got, want)
    assert _rel(got, want) <= REL_TOL


def test_preprocess_for_clip_refuses_non_square():
    x = np.zeros((1, 20, 30, 3), np.float32)
    with pytest.raises(ValueError) as want:
        jax_preprocess(jnp.asarray(x))
    with pytest.raises(ValueError) as got:
        preprocess_for_clip(torch.from_numpy(x))
    assert str(got.value) == str(want.value)


def test_hash_tokenizer_refused(tiny_clip_state, tmp_path, monkeypatch):
    monkeypatch.delenv("CFGPP_TOKENIZER_DIR", raising=False)
    ckpt = tmp_path / "clip.safetensors"
    save_file(tiny_clip_state, ckpt)
    jax_mod = import_module("cfgpp_tpu.metrics.clip_score")
    port_mod = import_module("cfgpp_tpu_torch.metrics.clip_score")
    monkeypatch.setattr("cfgpp_tpu.configs.CLIPTextConfig",
                        lambda **kw: JaxCLIPTextConfig(**dict(TINY_TEXT, **kw)))
    monkeypatch.setattr("cfgpp_tpu_torch.configs.CLIPTextConfig",
                        lambda **kw: CLIPTextConfig(**dict(TINY_TEXT, **kw)))
    with pytest.raises(ValueError) as want:
        jax_mod.clip_text_features(["a cat"], str(ckpt))
    with pytest.raises(ValueError) as got:
        port_mod.clip_text_features(["a cat"], str(ckpt), device="cpu")
    assert "hash-fallback" in str(want.value)
    assert str(got.value) == str(want.value)


def test_exports_equal():
    assert metrics.__all__ == jax_metrics.__all__
    assert dataclasses.asdict(CLIPVisionConfig()) == dataclasses.asdict(
        JaxVisionConfig())
    assert jax.default_backend() == "cpu"
