"""The port's int8 DiffusionEngine on a tiny SD-2.x config against
cfgpp_tpu's on its TPU route emulated (tests/torch_int8_route.py: the
Pallas kernels in interpret mode, proj_in on `int8_matmul`'s affine
prologue), in eps and in v form; the config, weights and requests of
tests/test_torch_port_sd2_engine.py, ``ddim_cfg++`` at lambda=0.6.

Tolerance: per step and image within 1e-2 x max(1, scale) in eps form,
the bound of the SD-1.5 int8 engine tests; 4e-2 x max(1, scale) in v
form.  In eps form the early steps' z0t divides the UNet's error by the
large scale of (z - sqrt(1 - abar) eps) / sqrt(abar); in v form z0t =
sqrt(abar) z - sqrt(1 - abar) v is the UNet's output itself near t = T,
so a step carries one whole int8 call's last-bit noise: these read
0.7-1.0e-2 (dense) and 1.5-2.2e-2 (all) x scale against the JAX route,
where the eps form reads at most 2.5e-3 and 5.4e-3.
tests/test_torch_port_sd2_models.py holds one whole int8 call to 4e-2 x
scale for the same reason (its module doc has the one-ulp evidence).
"""

import pytest

from cfgpp_tpu.engine import DiffusionEngine as JaxEngine
from cfgpp_tpu_torch.engine import DiffusionEngine
from tests.test_torch_port_sd2_engine import NFE, _bundles, _hold, _request
from tests.test_torch_port_sd2_engine import jax_params  # noqa: F401
from tests.torch_int8_route import emulate_tpu_route

INT8_TOL = {"eps": 1e-2, "v": 4e-2}     # module doc


@pytest.mark.parametrize("quant", ["dense", "all"])
@pytest.mark.parametrize("pred", ["eps", "v"])
def test_quantized_engine_matches_jax(jax_params, monkeypatch, pred, quant):
    jb, tb = _bundles(jax_params, pred, quant)
    emulate_tpu_route(monkeypatch)
    kw = _request("ddim_cfg++", 1)
    prompt = ["", "a photo of a cat"]
    want = JaxEngine(jb, "ddim_cfg++", nfe=NFE).sample(prompt,
                                                       cfg_guidance=0.6, **kw)
    got = DiffusionEngine(tb, "ddim_cfg++", nfe=NFE).sample(
        prompt, cfg_guidance=0.6, **kw)
    _hold(got, want, f"{pred} --quant {quant}", INT8_TOL[pred])
