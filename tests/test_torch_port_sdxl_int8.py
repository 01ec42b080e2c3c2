"""The port's int8 SDXL UNet and engine (``--quant dense`` / ``--quant
all``) on ``tiny_sdxl`` against cfgpp_tpu on its TPU route emulated
(tests/torch_int8_route.py: the Pallas kernels in interpret mode, proj_in
on `int8_matmul`'s affine prologue); weights as in
tests/test_torch_port_sdxl_models.py.

The quantized layout: the JAX package's ``quantized(mode).params()`` tree
loads strictly into the layers `quantize_unet_` makes from the float tree
(multi-layer transformer stacks, no level-0 attention), and the
``add_embedding`` and time embedding stay float on both sides.

Tolerances, the SD-2 int8 tests' bounds (tests/test_torch_port_sd2_
models.py has the evidence for them): the 2-layer transformer stack
within 1e-2 x max(1, max|ref|), and the int8 engine per step and image
within 4e-2 x max(1, w).  The factor max(1, w) is the chip run's rule for
a CFG step (``chip_smoke.py`` phase 7): the guided eps_hat = eps_uc + w
(eps_c - eps_uc) multiplies the error of the branches' difference by w,
and a multistep solver carries it on.  At w=5 (the main path's
``dpm++_2m_cfgpp``) the port reads 6.9-8.2e-2 (dense) and 7.9-10.9e-2
(all) x scale against the JAX route per step and image, while each branch
of the first UNet call reads at most 3.2e-2 (one whole int8 UNet call on
random inputs: within the SD-2 tests' 4e-2); the tiny SD-2 config, whose
engine tests/test_torch_port_sd2_int8_engine.py holds at 1e-2 at
lambda=0.6, reads 4.3e-2 (dense) and 5.9e-2 (all) under ``dpm++_2m`` at
w=7.5, so the growth with w is not SDXL's.  At lambda=0.6 (``ddim_cfg++``,
not run here) the port reads 1.8e-2 (dense) and 2.1e-2 (all), inside
4e-2.
"""

import numpy as np
import pytest
import torch

from cfgpp_tpu.engine import DiffusionEngine as JaxEngine
from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
from cfgpp_tpu_torch.models import quant as tq
from tests.test_torch_port_sdxl_engine import PROMPT, hold, request
from tests.test_torch_port_sdxl_models import T, _assert_close, jax_tiny_sdxl
from tests.torch_int8_route import emulate_tpu_route

TRANSFORMER_TOL = 1e-2   # the transformer stack (module doc)
INT8_TOL = 4e-2          # the engine, x max(1, w)


@pytest.fixture(scope="module")
def jax_bundle():
    return jax_tiny_sdxl()


@pytest.fixture(scope="module")
def quantized(jax_bundle):
    """{mode: (JAX quantized bundle, port bundle loaded from its tree)}."""
    out = {}
    for mode in ("dense", "all"):
        jq = jax_bundle.quantized(mode)
        out[mode] = jq, ModelBundle.from_flax(
            "tiny_sdxl", jq.params(), dtype=torch.float32, device="cpu",
            quant=mode)
    return out


@pytest.mark.parametrize("mode", ["dense", "all"])
def test_from_flax_loads_quantized_tree_strictly(jax_bundle, quantized,
                                                 mode):
    """The JAX tree loads strictly (``load_state_dict`` is strict) into the
    layers `quantize_unet_` makes from the float tree, leaf for leaf: both
    quantize the same sites."""
    _, tb = quantized[mode]
    ref = ModelBundle.from_flax("tiny_sdxl", jax_bundle.params(),
                                dtype=torch.float32,
                                device="cpu").quantized(mode)
    got, want = tb.unet.state_dict(), ref.unet.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=0)
    int8 = {k for k, v in got.items() if v.dtype == torch.int8}
    assert not any(k.startswith(("add_embedding", "time_embedding"))
                   for k in int8)
    assert got["add_embedding.linear_1.weight"].dtype == torch.float32
    stack = tb.unet.up_blocks[0].attentions[0]
    assert len(stack.transformer_blocks) == 2
    assert isinstance(stack.proj_in, tq.QuantLinear)
    assert isinstance(stack.transformer_blocks[1].attn1.to_qkv,
                      tq.QuantLinear)
    assert not hasattr(tb.unet.down_blocks[0], "attentions")
    convs = isinstance(tb.unet.down_blocks[0].resnets[0].conv1, tq.QuantConv)
    assert convs == (mode == "all")


@pytest.mark.parametrize("mode", ["dense", "all"])
def test_transformer_stack_matches_jax_route(monkeypatch, mode):
    """A 2-layer linear-projection stack at tiny_sdxl's level-1 width
    (64 channels, 2 heads, an 80-wide context) on the same inputs."""
    import jax
    import jax.numpy as jnp

    from cfgpp_tpu.models.unet import Transformer2DModel as JaxTransformer
    from cfgpp_tpu.weights.quantize import quantize_unet_params
    from cfgpp_tpu_torch.models.unet import Transformer2DModel
    from cfgpp_tpu_torch.weights.bridge import diffusers_state_dict
    from cfgpp_tpu_torch.weights.quantize import quantized_structure_
    from tests.test_torch_port_sdxl_models import _perturbed

    rng = np.random.default_rng(15)
    x = (2.0 * rng.standard_normal((2, 8, 8, 64)) + 0.5).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 80)).astype(np.float32)

    def jt(quant=False):
        return JaxTransformer(2, 32, 2, True, 8, quant=quant,
                              dtype=jnp.float32, param_dtype=jnp.float32)
    p = _perturbed(jt().init(jax.random.PRNGKey(1), jnp.asarray(x),
                             jnp.asarray(ctx)), 16)
    pq = quantize_unet_params(p, mode=mode)
    emulate_tpu_route(monkeypatch)
    want = jt(True if mode == "all" else mode).apply(pq, jnp.asarray(x),
                                                     jnp.asarray(ctx))
    tt = quantized_structure_(Transformer2DModel(64, 2, 32, 2, 80, 8,
                                                 linear=True), mode)
    tt.load_state_dict(diffusers_state_dict(pq))
    tt.requires_grad_(False)
    got = tt(T(x).permute(0, 3, 1, 2), T(ctx)).permute(0, 2, 3, 1)
    _assert_close(got, want, f"2-layer stack --quant {mode}", TRANSFORMER_TOL)


@pytest.mark.parametrize("mode", ["dense", "all"])
def test_quantized_engine_matches_jax_route(quantized, monkeypatch, mode):
    """The main path, ``dpm++_2m_cfgpp`` at w=5."""
    jq, tb = quantized[mode]
    emulate_tpu_route(monkeypatch)
    w = 5.0
    kw = dict(request("dpm++_2m_cfgpp"), cfg_guidance=w)
    want = JaxEngine(jq, "dpm++_2m_cfgpp", nfe=4).sample(PROMPT, **kw)
    got = DiffusionEngine(tb, "dpm++_2m_cfgpp", nfe=4).sample(PROMPT, **kw)
    hold(got, want, f"--quant {mode}", INT8_TOL * max(1.0, w))
    assert np.isfinite(np.asarray(got[0])).all()
