"""The port's DiffusionEngine against cfgpp_tpu's, end to end.

tiny_sd in f32, weights from the JAX package's ``ModelBundle.random_init``
through the weight bridge, the same zT injected into both engines
(``init_latent_override``: the two frameworks' random streams differ).  The
image and every step's (z0t, zt) must agree to 1e-4 x max(1, scale): both
sides are f32, and differences in summation order grow through NFE UNet
calls and the 1/sqrt(alpha_t) of each Tweedie estimate.

A second test runs the same slice through the port's CLI in a fresh
interpreter and checks that neither jax nor flax was imported.

The int8 ``quantized("dense")`` engines are held against each other with
the JAX package on its TPU route (tests/torch_int8_route.py: Pallas int8
kernels in interpret mode, bf16 kernel outputs on both sides).  Tolerance
1e-2 x max(1, scale): the sides differ in summation order (LayerNorm
statistics, convs), and a last-bit difference ahead of a quantize moves an
int8 level, whose effect grows through the NFE UNet calls and the Tweedie
estimate's 1/sqrt(alpha_t); a gap above this bound would be a fault, not
quantization noise.
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
from tests.torch_int8_route import emulate_tpu_route

REPO = Path(__file__).resolve().parents[1]


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


@pytest.mark.parametrize("solver,w,cond", [
    ("ddim_cfg++", 0.6, "a photo of a cat"),            # the slice's command
    ("ddim_cfg++", 0.6, ["a photo of a cat", "a dog"]),  # prompt list, B=2
    ("ddim", 1.0, "a photo of a cat"),                   # cond-only branch
])
def test_engine_matches_jax(bundles, solver, w, cond):
    jb, tb = bundles
    batch = len(cond) if isinstance(cond, list) else 1
    zT = np.random.default_rng(0).standard_normal((batch, 8, 8, 4)).astype(np.float32)
    kw = dict(cfg_guidance=w, resolution=16, init_latent_override=zT,
              return_trajectory=True)
    want_img, (want_z0, want_zt) = JaxEngine(jb, solver, nfe=4).sample(
        ["", cond], **kw)
    img, (z0s, zts) = DiffusionEngine(tb, solver, nfe=4).sample(["", cond], **kw)
    assert img.dtype == torch.float32 and img.shape == (batch, 16, 16, 3)
    assert 0.0 <= img.min().item() and img.max().item() <= 1.0
    assert z0s.shape == zts.shape == (4, batch, 8, 8, 4)
    for i in range(4):
        _assert_close(z0s[i], want_z0[i], f"z0t step {i}")
        _assert_close(zts[i], want_zt[i], f"zt step {i}")
    _assert_close(img, want_img, "image")


def test_quantized_engine_matches_jax(bundles, monkeypatch):
    jb, _ = bundles
    jq = jb.quantized("dense")
    tq = ModelBundle.from_flax("tiny_sd", jq.params(), dtype=torch.float32,
                               device="cpu", quant="dense")
    emulate_tpu_route(monkeypatch)
    zT = np.random.default_rng(1).standard_normal((1, 8, 8, 4)).astype(np.float32)
    kw = dict(cfg_guidance=0.6, resolution=16, init_latent_override=zT,
              return_trajectory=True)
    prompt = ["", "a photo of a cat"]
    want_img, (want_z0, want_zt) = JaxEngine(jq, "ddim_cfg++", nfe=4).sample(
        prompt, **kw)
    img, (z0s, zts) = DiffusionEngine(tq, "ddim_cfg++", nfe=4).sample(
        prompt, **kw)
    for i in range(4):
        _assert_close(z0s[i], want_z0[i], f"int8 z0t step {i}", tol=1e-2)
        _assert_close(zts[i], want_zt[i], f"int8 zt step {i}", tol=1e-2)
    _assert_close(img, want_img, "int8 image", tol=1e-2)


def test_to_uint8_rounds_half_up():
    img = torch.tensor([0.0, 0.5, 1.0, 0.999])
    assert DiffusionEngine._to_uint8(img).tolist() == [0, 128, 255, 255]


def test_cli_slice_runs_without_jax(tmp_path):
    """The tiny slice through the CLI on the CPU, in a fresh interpreter."""
    code = (
        "import sys\n"
        "from cfgpp_tpu_torch.cli.text_to_img import main\n"
        "main(['--model', 'tiny_sd', '--device', 'cpu', '--dtype', 'float32',\n"
        "      '--method', 'ddim_cfg++', '--cfg_guidance', '0.6', '--NFE', '4',\n"
        "      '--resolution', '16', '--prompt', 'a cat',\n"
        f"      '--workdir', {str(tmp_path)!r}])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('cfgpp_tpu', 'jax', 'jaxlib',\n"
        "                                 'flax'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    from PIL import Image
    png = Image.open(tmp_path / "result" / "generated.png")
    assert png.size == (16, 16) and png.mode == "RGB"
    arr = np.asarray(png)
    assert arr.min() == 0 and arr.max() == 255   # min-max normalized


def test_cli_quant_dense_runs_without_jax(tmp_path):
    """``--quant dense`` on tiny_sd through the CLI, in a fresh interpreter:
    the int8 UNet runs (its wrappers' plain versions on the CPU) and neither
    jax nor flax is imported."""
    code = (
        "import sys\n"
        "from cfgpp_tpu_torch.cli.text_to_img import main\n"
        "import cfgpp_tpu_torch.kernels.int8_matmul as q\n"
        "import cfgpp_tpu_torch.models.quant as m\n"
        "calls = []\n"
        "ref = q.int8_matmul_reference\n"
        "q.int8_matmul_reference = lambda *a, **k: calls.append(1) or ref(*a, **k)\n"
        "main(['--model', 'tiny_sd', '--device', 'cpu', '--dtype', 'float32',\n"
        "      '--method', 'ddim_cfg++', '--cfg_guidance', '0.6', '--NFE', '2',\n"
        "      '--resolution', '16', '--prompt', 'a cat', '--quant', 'dense',\n"
        f"      '--workdir', {str(tmp_path)!r}])\n"
        "assert calls, 'no int8 projection ran'\n"
        "bad = sorted(mod for mod in sys.modules\n"
        "             if mod.split('.')[0] in ('cfgpp_tpu', 'jax', 'jaxlib',\n"
        "                                 'flax'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "result" / "generated.png").is_file()
