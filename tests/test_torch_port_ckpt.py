"""The port's checkpoint loaders against the JAX package's, on ``tiny_sd``
and ``tiny_sdxl``: ``ModelBundle.from_pretrained`` (``--ckpt_dir``), the
native checkpoint (``save_bundle`` / ``load_bundle``) and
``cli/convert_checkpoint.py``.

An HF-layout directory is written from the JAX bundle's trees (made as in
tests/test_torch_port_sdxl_models.py) with the safetensors package and the
independent Flax -> torch emitter of tests/test_convert_roundtrip.py: the
UNet in two shard files (merged in sorted order), one family's VAE with the
legacy attention names (``query``/``key``/``value``/``proj_attn``), the
first text encoder as a combined CLIPModel file (a vision tower,
``visual_projection``, ``logit_scale`` and int64 ``position_ids`` beside
the text half), and tiny_sd's UNet in f16 (each side casts it to f32).  The
JAX side loads it with ``ModelBundle.from_pretrained``, its
``random_init`` replaced by a copy of the already built bundle (the JAX
initializers cost about 27 s to compile; ``from_pretrained`` overwrites
every parameter).  Every tensor of the port's bundle must equal
``ModelBundle.from_flax`` of the JAX-loaded trees exactly, and one
``DiffusionEngine.sample`` per family from both bundles must agree per
step within 1e-4 x max(1, scale) (f32 on both sides, the engine tests'
bound).
"""

import dataclasses
import shutil

import numpy as np
import pytest
import safetensors.numpy
import torch

from cfgpp_tpu.engine import DiffusionEngine as JaxEngine
from cfgpp_tpu.engine import ModelBundle as JaxBundle
from cfgpp_tpu_torch.cli import convert_checkpoint
from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
from cfgpp_tpu_torch.weights.checkpoint import load_bundle, save_bundle
from tests.test_convert_roundtrip import _emit, _np_params
from tests.test_torch_port_sdxl_models import _assert_close, jax_tiny_bundle

EXACT_TOL = 1e-4
FAMILIES = ["tiny_sd", "tiny_sdxl"]


def assert_bundles_equal(got: ModelBundle, want: ModelBundle):
    for attr in ("unet", "vae", "text_encoder", "text_encoder_2"):
        g, w = getattr(got, attr), getattr(want, attr)
        assert (g is None) == (w is None), attr
        if g is None:
            continue
        gs, ws = g.state_dict(), w.state_dict()
        assert sorted(gs) == sorted(ws), attr
        for k in ws:
            assert gs[k].dtype == ws[k].dtype, (attr, k)
            assert torch.equal(gs[k], ws[k]), (attr, k)


def clip_state(params):
    """A JAX CLIP text tree -> transformers names (the emitter of
    tests/test_convert_roundtrip.py:test_clip_text_roundtrip)."""
    state = {}
    for k, v in _np_params(params)["params"].items():
        if k == "token_embedding":
            state["text_model.embeddings.token_embedding.weight"] = \
                np.asarray(v["embedding"])
        elif k == "position_embedding":
            state["text_model.embeddings.position_embedding.weight"] = \
                np.asarray(v)
        elif k == "text_projection":
            state["text_projection.weight"] = np.asarray(v["kernel"]).T
        elif k == "final_layer_norm":
            state["text_model.final_layer_norm.weight"] = np.asarray(v["scale"])
            state["text_model.final_layer_norm.bias"] = np.asarray(v["bias"])
        else:
            state.update(_emit({k: v}, "text_model.encoder."))
    return state


def write_hf_dir(jb, root):
    """The JAX bundle's trees as an HF-layout checkpoint directory."""
    legacy = jb.config.family == "sd"
    unet = _emit(_np_params(jb.unet_params)["params"])
    if legacy:
        unet = {k: v.astype(np.float16) for k, v in unet.items()}
    vae = _emit(_np_params(jb.vae_params)["params"])
    if legacy:
        names = {"to_q": "query", "to_k": "key", "to_v": "value",
                 "to_out.0": "proj_attn"}
        vae = {next((k.replace(f".{a}.", f".{b}.") for a, b in names.items()
                     if f"attentions.0.{a}." in k), k): v
               for k, v in vae.items()}
        assert any(".proj_attn." in k for k in vae)
    text = clip_state(jb.text_params)
    rng = np.random.default_rng(5)
    text.update({"text_model.embeddings.position_ids":
                 np.arange(77, dtype=np.int64)[None],
                 "vision_model.embeddings.class_embedding":
                 rng.standard_normal(8).astype(np.float32),
                 "vision_model.encoder.layers.0.mlp.fc1.weight":
                 rng.standard_normal((4, 8)).astype(np.float32),
                 "visual_projection.weight":
                 rng.standard_normal((4, 8)).astype(np.float32),
                 "logit_scale": np.array(2.6592, np.float32)})
    keys = sorted(unet)
    files = {("unet", "diffusion_pytorch_model-00001-of-00002"):
             {k: unet[k] for k in keys[:len(keys) // 2]},
             ("unet", "diffusion_pytorch_model-00002-of-00002"):
             {k: unet[k] for k in keys[len(keys) // 2:]},
             ("vae", "diffusion_pytorch_model"): vae,
             ("text_encoder", "model"): text}
    if jb.text_params_2 is not None:
        files[("text_encoder_2", "model")] = clip_state(jb.text_params_2)
    for (sub, name), state in files.items():
        (root / sub).mkdir(parents=True, exist_ok=True)
        safetensors.numpy.save_file(
            {k: np.ascontiguousarray(v) for k, v in state.items()},
            str(root / sub / f"{name}.safetensors"))
    return root


class Family:
    def __init__(self, name, root):
        self.name = name
        self.jax_src = jax_tiny_bundle(name)
        self.dir = write_hf_dir(self.jax_src, root)

    def jax_from_pretrained(self, monkeypatch, path=None):
        """JAX's ``ModelBundle.from_pretrained`` with its ``random_init``
        replaced by a copy of the built bundle."""
        def random_init(config_or_name, **kw):
            return dataclasses.replace(self.jax_src)
        monkeypatch.setattr(JaxBundle, "random_init", random_init)
        return JaxBundle.from_pretrained(str(path or self.dir), self.name)


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    return {name: Family(name, tmp_path_factory.mktemp(name))
            for name in FAMILIES}


@pytest.mark.parametrize("name", FAMILIES)
def test_from_pretrained_equals_jax(families, monkeypatch, name):
    fam = families[name]
    jb = fam.jax_from_pretrained(monkeypatch)
    want = ModelBundle.from_flax(name, jb.params(), dtype=torch.float32,
                                 device="cpu")
    got = ModelBundle.from_pretrained(fam.dir, name, dtype=torch.float32,
                                      device="cpu")
    assert_bundles_equal(got, want)
    if name == "tiny_sd":       # the f16 file moved the weights: both sides
        assert not np.array_equal(
            np.asarray(jb.unet_params["params"]["conv_in"]["kernel"]),
            np.asarray(fam.jax_src.unet_params["params"]["conv_in"]["kernel"]))

    solver, w = (("ddim_cfg++", 0.6) if name == "tiny_sd"
                 else ("dpm++_2m_cfgpp", 5.0))
    z = np.random.default_rng(11).standard_normal((1, 8, 8, 4)).astype(
        np.float32)
    kw = dict(cfg_guidance=w, resolution=16,
              init_latent_override=z, return_trajectory=True)
    want_img, (want_z0, want_zt) = JaxEngine(jb, solver, nfe=3).sample(
        ["", "a photo of a cat"], **kw)
    img, (z0s, zts) = DiffusionEngine(got, solver, nfe=3).sample(
        ["", "a photo of a cat"], **kw)
    for i in range(len(want_z0)):
        _assert_close(z0s[i], want_z0[i], f"{name} z0t step {i}", EXACT_TOL)
        _assert_close(zts[i], want_zt[i], f"{name} zt step {i}", EXACT_TOL)
    _assert_close(img, want_img, f"{name} image", EXACT_TOL)


def _damaged_copy(src, dst, edit):
    shutil.copytree(src, dst)
    path = dst / "unet" / "diffusion_pytorch_model-00002-of-00002.safetensors"
    state = safetensors.numpy.load_file(str(path))
    edit(state)
    safetensors.numpy.save_file(state, str(path))
    return dst


@pytest.mark.parametrize("damage", ["missing", "extra", "shape"])
def test_structure_mismatch_raises_as_jax(families, monkeypatch, tmp_path,
                                          damage):
    fam = families["tiny_sdxl"]

    def edit(state):
        key = sorted(k for k in state if k.endswith("conv1.weight"))[0]
        if damage == "missing":
            del state[key]
        elif damage == "extra":
            state["up_blocks.0.bogus.weight"] = np.zeros(3, np.float32)
        else:
            state[key] = np.ascontiguousarray(state[key][:, :-1])

    bad = _damaged_copy(fam.dir, tmp_path / "bad", edit)
    match = "shape mismatches" if damage == "shape" else "mismatch; missing="
    with pytest.raises(ValueError, match=match):
        ModelBundle.from_pretrained(bad, "tiny_sdxl", dtype=torch.float32,
                                    device="cpu")
    with pytest.raises(ValueError, match=match):
        fam.jax_from_pretrained(monkeypatch, bad)


def test_clip_file_without_text_keys_raises(families, tmp_path):
    bad = tmp_path / "bad"
    shutil.copytree(families["tiny_sd"].dir, bad)
    safetensors.numpy.save_file(
        {"vision_model.embeddings.class_embedding": np.zeros(4, np.float32)},
        str(bad / "text_encoder" / "model.safetensors"))
    with pytest.raises(KeyError, match="no text_model"):
        ModelBundle.from_pretrained(bad, "tiny_sd", dtype=torch.float32,
                                    device="cpu")


def test_native_checkpoint_round_trip_is_exact(tmp_path):
    src = ModelBundle.random_init("tiny_sdxl", seed=3, dtype=torch.bfloat16,
                                  device="cpu")
    save_bundle(src, tmp_path / "ckpt")
    assert (tmp_path / "ckpt" / "BUNDLE").read_text() == "tiny_sdxl"
    dst = ModelBundle.random_init("tiny_sdxl", seed=4, dtype=torch.bfloat16,
                                  device="cpu")
    assert not torch.equal(dst.unet.conv_in.weight, src.unet.conv_in.weight)
    assert_bundles_equal(load_bundle(dst, tmp_path / "ckpt"), src)
    assert dst.unet.conv_in.weight.dtype == torch.bfloat16
    assert dst.vae.decoder.conv_in.weight.dtype == torch.float32
    # the native format is the HF layout from_pretrained reads
    assert_bundles_equal(ModelBundle.from_pretrained(
        tmp_path / "ckpt", "tiny_sdxl", dtype=torch.bfloat16, device="cpu"),
        src)


def test_native_checkpoint_rules_of_jax(tmp_path):
    sd = ModelBundle.random_init("tiny_sd", seed=0, dtype=torch.float32,
                                 device="cpu")
    xl = ModelBundle.random_init("tiny_sdxl", seed=0, dtype=torch.float32,
                                 device="cpu")
    save_bundle(sd, tmp_path / "sd")
    with pytest.raises(ValueError, match="checkpoint is for 'tiny_sd'"):
        load_bundle(xl, tmp_path / "sd")
    save_bundle(xl, tmp_path / "xl")
    shutil.rmtree(tmp_path / "xl" / "text_encoder_2")
    with pytest.raises(FileNotFoundError, match="no text_encoder_2"):
        load_bundle(xl, tmp_path / "xl")


def test_convert_checkpoint_from_hf_dir(families, tmp_path, capsys):
    fam = families["tiny_sdxl"]
    convert_checkpoint.main(["--model", "tiny_sdxl", "--src", str(fam.dir),
                             "--dst", str(tmp_path / "out"), "--dtype",
                             "float32", "--device", "cpu"])
    assert "saved native checkpoint" in capsys.readouterr().out
    assert_bundles_equal(
        ModelBundle.from_pretrained(tmp_path / "out", "tiny_sdxl",
                                    dtype=torch.float32, device="cpu"),
        ModelBundle.from_pretrained(fam.dir, "tiny_sdxl", dtype=torch.float32,
                                    device="cpu"))


@pytest.mark.parametrize("argv", [[], ["--src", "a", "--single_file", "b"]],
                         ids=["neither", "both"])
def test_convert_checkpoint_needs_exactly_one_source(tmp_path, argv, capsys):
    with pytest.raises(SystemExit) as e:
        convert_checkpoint.main(["--model", "tiny_sdxl", "--dst",
                                 str(tmp_path), "--device", "cpu"] + argv)
    assert e.value.code != 0
    assert "exactly one of --src / --single_file" in capsys.readouterr().err
