"""The port's DiffusionEngine on a tiny SD-2.x config against cfgpp_tpu's.

The config is tests/test_torch_port_sd2_models.py's ``sd2_config`` (linear
projections, erf-gelu CLIP) in eps and in v form: a v-prediction UNet's
output becomes eps at the engine's model boundary (``eps = sqrt(abar_t) v
+ sqrt(1 - abar_t) z``, ``cfgpp_tpu/engine/pipeline.py:135-140``), in the
batch-2B pair and in the single branch, so every solver, the inversion and
the edit see eps.  Weights from the JAX package's ``random_init`` (UNet
leaves perturbed) through the bridge; the same zT (or encoded source
latent) injected into both engines.

Tolerance: every step's (z0t, zt) and the image within 1e-4 x max(1,
scale), the rule of tests/test_torch_port_engine.py (f32 on both sides).
The int8 forms are in tests/test_torch_port_sd2_int8_engine.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgpp_tpu.configs import tiny_sd_config as jax_tiny_sd_config
from cfgpp_tpu.engine import DiffusionEngine as JaxEngine
from cfgpp_tpu.engine import ModelBundle as JaxBundle
from cfgpp_tpu_torch.configs import tiny_sd_config
from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
from tests.test_torch_port_sd2_models import _perturbed, sd2_config

NFE = 4
EXACT_TOL = 1e-4
PREDICTIONS = {"eps": "epsilon", "v": "v_prediction"}


def _assert_close(got, want, what, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= tol * max(1.0, scale), f"{what}: max err {err} (scale {scale})"


@pytest.fixture(scope="module")
def jax_params():
    jb = JaxBundle.random_init(sd2_config(jax_tiny_sd_config), seed=0,
                               dtype=jnp.float32, param_dtype=jnp.float32)
    jb.unet_params = _perturbed(jb.unet_params, 7)
    return jb


def _bundles(jb, pred, quant=None):
    """(JAX bundle, port bundle) of the tiny SD-2 config with prediction
    type ``pred`` ("eps" or "v"): the same parameter trees."""
    jcfg = sd2_config(jax_tiny_sd_config, PREDICTIONS[pred])
    jb = dataclasses.replace(jb, config=jcfg)
    if quant is not None:
        jb = jb.quantized(quant)
    tb = ModelBundle.from_flax(sd2_config(tiny_sd_config, PREDICTIONS[pred]),
                               jb.params(), dtype=torch.float32,
                               device="cpu", quant=quant)
    return jb, tb


def _request(solver, batch):
    rng = np.random.default_rng(11)
    kw = dict(resolution=16, return_trajectory=True)
    if "inversion" in solver:
        kw.update(src_img=rng.uniform(-1, 1, (batch, 16, 16, 3)).astype(
            np.float32), src_latent_override=rng.standard_normal(
            (batch, 8, 8, 4)).astype(np.float32))
    else:
        kw["init_latent_override"] = rng.standard_normal(
            (batch, 8, 8, 4)).astype(np.float32)
    return kw


def _hold(got, want, what, tol):
    img, (z0s, zts) = got
    want_img, (want_z0, want_zt) = want
    assert z0s.shape[0] == NFE
    for i in range(NFE):
        _assert_close(z0s[i], want_z0[i], f"{what} z0t step {i}", tol)
        _assert_close(zts[i], want_zt[i], f"{what} zt step {i}", tol)
    _assert_close(img, want_img, f"{what} image", tol)


@pytest.mark.parametrize("pred", ["eps", "v"])
@pytest.mark.parametrize("solver,w", [
    ("ddim_cfg++", 0.6),              # batch-2B pair
    ("euler_cfg++", 0.6),
    ("dpm++_2m", 7.5),
    ("ddim_inversion_cfg++", 0.6),
    ("ddim", 1.0),                    # the single (cond-only) branch
])
def test_engine_matches_jax(jax_params, pred, solver, w):
    jb, tb = _bundles(jax_params, pred)
    kw = _request(solver, 1)
    prompt = ["", "a photo of a cat"]
    want = JaxEngine(jb, solver, nfe=NFE).sample(prompt, cfg_guidance=w, **kw)
    got = DiffusionEngine(tb, solver, nfe=NFE).sample(prompt, cfg_guidance=w,
                                                      **kw)
    _hold(got, want, f"{pred} {solver}", EXACT_TOL)


def test_v_form_differs_from_eps_form(jax_params):
    """The v -> eps conversion runs: the same weights read as v give
    another trajectory (and the engine keeps alpha-bar on the device)."""
    _, tb_eps = _bundles(jax_params, "eps")
    _, tb_v = _bundles(jax_params, "v")
    kw = _request("ddim_cfg++", 1)
    e_v = DiffusionEngine(tb_v, "ddim_cfg++", nfe=NFE)
    e_eps = DiffusionEngine(tb_eps, "ddim_cfg++", nfe=NFE)
    assert e_eps._abar is None
    assert e_v._abar.dtype == torch.float32 and e_v._abar.shape == (1000,)
    _, (z0_v, _) = e_v.sample(["", "a cat"], cfg_guidance=0.6, **kw)
    _, (z0_e, _) = e_eps.sample(["", "a cat"], cfg_guidance=0.6, **kw)
    assert float((z0_v - z0_e).abs().max()) > 1e-2
