"""The port's inversion and word-swap edit against cfgpp_tpu's engine.

tiny_sd in f32, weights from the JAX package's ``ModelBundle.random_init``
through the weight bridge.  The two frameworks' random streams differ, so
the encoded source latent is injected into both engines
(``src_latent_override``, as ``cfgpp_tpu/cli/parity_check.py`` does); the
source image is still passed, and must be.  Per-step (z0t, zt) and the
image must agree to 1e-4 x max(1, scale), the rule of
``tests/test_torch_port_engine.py``: both sides are f32, and differences in
summation order grow through the inversion's and the sampler's UNet calls.

The VAE encode is held by its mean and std against the JAX bundle's f32
encoder, and the engine's argument errors against the JAX engine's.  The
last test runs the port's inversion CLI in a fresh interpreter.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgpp_tpu.engine import DiffusionEngine as JaxEngine
from cfgpp_tpu.engine import ModelBundle as JaxBundle
from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
from cfgpp_tpu_torch.utils.img import save_image

REPO = Path(__file__).resolve().parents[1]
NFE = 4


def _assert_close(got, want, what, tol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= tol * max(1.0, scale), f"{what}: max err {err} (scale {scale})"


@pytest.fixture(scope="module")
def bundles():
    jb = JaxBundle.random_init("tiny_sd", seed=0, dtype=jnp.float32,
                               param_dtype=jnp.float32)
    tb = ModelBundle.from_flax("tiny_sd", jb.params(), dtype=torch.float32,
                               device="cpu")
    return jb, tb


def _src(batch):
    rng = np.random.default_rng(3)
    img = rng.uniform(-1.0, 1.0, (batch, 16, 16, 3)).astype(np.float32)
    z0 = rng.standard_normal((batch, 8, 8, 4)).astype(np.float32)
    return img, z0


@pytest.mark.parametrize("solver,w,latent_init,prompt", [
    ("ddim_inversion", 1.0, None, ["", "a cat"]),
    ("ddim_inversion", 7.5, "ddim", ["", "a cat"]),
    ("ddim_inversion_cfg++", 0.6, None, ["", ["a cat", "a dog"]]),
    ("ddim_inversion_cfg++", 0.6, "npi", ["", "a cat"]),
    ("ddim_inversion", 7.5, "npi", ["", "a cat"]),
    ("ddim_edit", 7.5, None, ["", "a cat", "a dog"]),
    ("ddim_edit_cfg++", 0.6, None, ["", ["a cat", "a cow"], ["a dog", "a hen"]]),
    ("ddim_edit_cfg++", 0.6, "npi", ["", "a cat", "a dog"]),
])
def test_inversion_engine_matches_jax(bundles, solver, w, latent_init, prompt):
    jb, tb = bundles
    batch = max(len(p) if isinstance(p, list) else 1 for p in prompt[1:])
    img, z0 = _src(batch)
    kw = dict(cfg_guidance=w, resolution=16, src_img=img,
              src_latent_override=z0, latent_init=latent_init,
              return_trajectory=True)
    want_img, (want_z0, want_zt) = JaxEngine(jb, solver, nfe=NFE).sample(
        prompt, **kw)
    got_img, (z0s, zts) = DiffusionEngine(tb, solver, nfe=NFE).sample(
        prompt, **kw)
    assert got_img.shape == (batch, 16, 16, 3)
    assert z0s.shape == zts.shape == (NFE, batch, 8, 8, 4)
    for i in range(NFE):
        _assert_close(z0s[i], want_z0[i], f"z0t step {i}")
        _assert_close(zts[i], want_zt[i], f"zt step {i}")
    _assert_close(got_img, want_img, "image")


def test_inversion_reconstructs_through_encode(bundles):
    """Without the override the port encodes the source image itself: the
    same seed gives the same images, another seed another encode draw."""
    _, tb = bundles
    img, _ = _src(1)
    eng = DiffusionEngine(tb, "ddim_inversion_cfg++", nfe=NFE)
    runs = [eng.sample(["", "a cat"], cfg_guidance=0.6, seed=s,
                       resolution=16, src_img=img) for s in (1, 1, 2)]
    assert all(bool(torch.isfinite(r).all()) for r in runs)
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_encode_mean_and_std_match_jax(bundles):
    jb, tb = bundles
    img = np.random.default_rng(4).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    vae32 = jb.vae_encode
    mean_j, logvar_j = vae32.apply(jb.vae_params, jnp.asarray(img),
                                   method=vae32.encode)
    with torch.inference_mode():
        mean_t, logvar_t = tb.vae.encode(torch.from_numpy(img))
    _assert_close(mean_t, mean_j, "encode mean", tol=1e-5)
    _assert_close(torch.exp(0.5 * logvar_t), np.exp(0.5 * np.asarray(logvar_j)),
                  "encode std", tol=1e-5)
    # _encode is the reparameterized draw from its generator, scaled
    eng = DiffusionEngine(tb, "ddim_inversion", nfe=NFE)
    gen = torch.Generator().manual_seed(9)
    with torch.inference_mode():
        z = eng._encode(torch.from_numpy(img), gen)
    n = torch.randn(mean_t.shape, generator=torch.Generator().manual_seed(9))
    scale = tb.config.vae.scaling_factor
    torch.testing.assert_close(z, (mean_t + torch.exp(0.5 * logvar_t) * n) * scale,
                               rtol=0, atol=0)


ERRORS = [
    ("ddim_inversion", dict(latent_init="bogus"), "unknown latent_init"),
    ("ddim_cfg++", dict(latent_init="npi"), "requires an inversion solver"),
    ("ddim_inversion", dict(), "needs src_imgs"),
    ("ddim_inversion", dict(src_img=np.zeros((2, 16, 16, 3), np.float32)),
     "2 src imgs vs batch 1"),
    ("ddim_edit", dict(prompt=["", ["a", "b"], ["c"]],
                       src_img=np.zeros((2, 16, 16, 3), np.float32)),
     "prompt lists must share one batch size"),
]


@pytest.mark.parametrize("solver,kw,msg", ERRORS)
def test_engine_errors_match_jax(bundles, solver, kw, msg):
    jb, tb = bundles
    kw = dict(kw)
    prompt = kw.pop("prompt", ["", "a cat"])
    for eng in (JaxEngine(jb, solver, nfe=NFE), DiffusionEngine(tb, solver, nfe=NFE)):
        with pytest.raises(ValueError, match=msg):
            eng.sample(prompt, cfg_guidance=7.5, resolution=16, **kw)


def test_noise_override_shape_checked(bundles):
    _, tb = bundles
    eng = DiffusionEngine(tb, "euler_a", nfe=NFE)
    with pytest.raises(ValueError, match="noise_override: shape"):
        eng.sample(["", "a cat"], resolution=16,
                   noise_override=np.zeros((NFE - 1, 1, 8, 8, 4), np.float32))


def test_inversion_cli_runs_without_jax(tmp_path):
    """The inversion CLI on tiny_sd on the CPU, in a fresh interpreter: it
    reads a PNG, inverts and resamples, and writes reconstruct.png."""
    src = tmp_path / "src.png"
    save_image(np.random.default_rng(0).uniform(0, 1, (24, 20, 3)), src)
    code = (
        "import sys\n"
        "from cfgpp_tpu_torch.cli.inversion import main\n"
        "main(['--model', 'tiny_sd', '--device', 'cpu', '--dtype', 'float32',\n"
        "      '--NFE', '3', '--img_size', '16', '--prompt', 'a cat',\n"
        f"      '--img_path', {str(src)!r}, '--workdir', {str(tmp_path)!r}])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('cfgpp_tpu', 'jax', 'jaxlib',\n"
        "                                 'flax'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    from PIL import Image
    png = Image.open(tmp_path / "result" / "reconstruct.png")
    assert png.size == (16, 16) and png.mode == "RGB"
