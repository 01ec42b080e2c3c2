"""The port's SGM single-file loader (``cfgpp_tpu_torch/weights/
single_file.py``) and its inverse map (``cfgpp_tpu_torch/tools/
sgm_synth.py``) against the JAX package's.

* The JAX ``tiny_sdxl`` bundle (made as in
  tests/test_torch_port_sdxl_models.py) is written as a full single file by
  the JAX test helper ``tests/sgm_synth.synth_single_file`` and the
  safetensors package; JAX's ``load_single_file_bundle`` and the port's
  ``load_single_file`` load it, and every tensor of the port's bundle must
  equal ``ModelBundle.from_flax`` of the JAX-loaded trees exactly, and so
  must the native checkpoint ``convert_checkpoint --single_file`` writes.
* The port's inverse map of the same weights must equal the JAX helper's
  output key for key and bit for bit.
* ``_unet_layout`` equals JAX's for the sd15, sdxl and tiny_sdxl configs;
  the full-width sdxl bundle, built on the meta device (nothing
  materialized), goes through the inverse map and the converter back to
  every state-dict name and shape of its four modules.
* An unknown key and a UNet-only file raise as in JAX.

Tolerance: none (names, shapes, dtypes and values equal).
"""

import dataclasses

import numpy as np
import pytest
import safetensors.numpy
import torch

from cfgpp_tpu.configs import get_bundle_config as jax_bundle_config
from cfgpp_tpu.weights import single_file as jax_single_file
from cfgpp_tpu_torch.cli import convert_checkpoint
from cfgpp_tpu_torch.configs import get_bundle_config
from cfgpp_tpu_torch.engine import ModelBundle
from cfgpp_tpu_torch.tools import sgm_synth
from cfgpp_tpu_torch.weights import single_file
from tests.sgm_synth import synth_single_file as jax_synth
from tests.test_torch_port_ckpt import assert_bundles_equal
from tests.test_torch_port_sdxl_models import jax_tiny_bundle


@pytest.fixture(scope="module")
def jax_bundle():
    return jax_tiny_bundle("tiny_sdxl")


@pytest.fixture(scope="module")
def sgm_file(jax_bundle, tmp_path_factory):
    path = tmp_path_factory.mktemp("sgm") / "lightning.safetensors"
    safetensors.numpy.save_file(jax_synth(jax_bundle), str(path))
    return path


def empty_bundle(name="tiny_sdxl", device="cpu"):
    return ModelBundle._empty(name, torch.float32, torch.device(device), None)


def test_load_single_file_equals_jax(jax_bundle, sgm_file):
    jb = jax_single_file.load_single_file_bundle(
        dataclasses.replace(jax_bundle), str(sgm_file))
    want = ModelBundle.from_flax("tiny_sdxl", jb.params(), dtype=torch.float32,
                                 device="cpu")
    assert_bundles_equal(single_file.load_single_file(empty_bundle(),
                                                      sgm_file), want)
    assert_bundles_equal(ModelBundle.from_single_file(
        sgm_file, "tiny_sdxl", dtype=torch.float32, device="cpu"), want)


def test_convert_checkpoint_from_single_file(jax_bundle, sgm_file, tmp_path):
    """``convert_checkpoint --single_file`` writes the native layout of the
    JAX-loaded weights."""
    jb = jax_single_file.load_single_file_bundle(
        dataclasses.replace(jax_bundle), str(sgm_file))
    convert_checkpoint.main(["--model", "tiny_sdxl", "--single_file",
                             str(sgm_file), "--dst", str(tmp_path / "out"),
                             "--dtype", "float32", "--device", "cpu"])
    assert_bundles_equal(
        ModelBundle.from_pretrained(tmp_path / "out", "tiny_sdxl",
                                    dtype=torch.float32, device="cpu"),
        ModelBundle.from_flax("tiny_sdxl", jb.params(), dtype=torch.float32,
                              device="cpu"))


def test_inverse_map_equals_the_jax_helper(jax_bundle):
    want = jax_synth(jax_bundle)
    got = sgm_synth.synth_single_file(ModelBundle.from_flax(
        "tiny_sdxl", jax_bundle.params(), dtype=torch.float32, device="cpu"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.is_contiguous() and g.dtype == torch.float32, k
        assert tuple(g.shape) == w.shape, k
        assert np.array_equal(g.numpy(), w), k


@pytest.mark.parametrize("name", ["sd15", "sdxl", "tiny_sdxl"])
def test_unet_layout_equals_jax(name):
    assert single_file._unet_layout(get_bundle_config(name).unet) == \
        jax_single_file._unet_layout(jax_bundle_config(name).unet)


def test_full_width_sdxl_name_and_shape_map_on_meta():
    bundle = empty_bundle("sdxl", "meta")
    state = sgm_synth.synth_single_file(bundle)
    assert all(v.is_meta for v in state.values())
    trees = single_file.convert_single_file(state, bundle.config)
    for what, module in (("unet", bundle.unet), ("vae", bundle.vae),
                         ("text", bundle.text_encoder),
                         ("text2", bundle.text_encoder_2)):
        want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in trees[what].items()} == want, \
            what
    # SGM's own counts of the SDXL UNet: 9 input, 9 output blocks
    for blocks in ("input_blocks", "output_blocks"):
        ids = {int(k.split(".")[3]) for k in state
               if k.startswith(f"model.diffusion_model.{blocks}.")}
        assert ids == set(range(9)), blocks


def test_unknown_key_raises_as_jax(jax_bundle):
    state = jax_synth(jax_bundle)
    state["model.diffusion_model.bogus.weight"] = np.zeros(1, np.float32)
    with pytest.raises(KeyError, match="unhandled SGM UNet key"):
        jax_single_file.convert_single_file(state, jax_bundle.config)
    with pytest.raises(KeyError, match="unhandled SGM UNet key"):
        single_file.convert_single_file(
            {k: torch.from_numpy(v) for k, v in state.items()},
            get_bundle_config("tiny_sdxl"))


def test_unet_only_file_raises_as_jax(jax_bundle, tmp_path):
    path = tmp_path / "unet_only.safetensors"
    safetensors.numpy.save_file(
        {k: v for k, v in jax_synth(jax_bundle).items()
         if k.startswith("model.diffusion_model.")}, str(path))
    with pytest.raises(KeyError, match="no text_model"):
        jax_single_file.load_single_file_bundle(
            dataclasses.replace(jax_bundle), str(path))
    with pytest.raises(KeyError, match="no text_model"):
        single_file.load_single_file(empty_bundle(), path)
