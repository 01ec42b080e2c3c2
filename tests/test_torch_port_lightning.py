"""The port's 5 SDXL-Lightning solvers against cfgpp_tpu's, on
``tiny_sdxl``.

* Registry: ``list_solvers("sdxl")`` equals JAX's, and each Lightning spec
  equals JAX's field by field (``lightning=True``, trailing spacing), its
  plan function included.
* Plans: at 4 NFE (the reference's Lightning command) and 8, each plan of
  the trailing schedule equals JAX's array by array (dtype and value).
* Engine: the tiny_sdxl engines of tests/test_torch_port_sdxl_engine.py at
  w=1, the same zT injected: every step's (z0t, zt) and the image within
  1e-4 x max(1, scale) (f32 on both sides).  JAX's engine substitutes the
  literal 1.0 for w in its Lightning core; the port's does too.
* Branches: ``ddim_lightning`` and ``euler_lightning`` are CFG forms, so
  at w=1 they run the conditional branch alone (a batch-B UNet call,
  ``_needs_branches``); the CFG++ forms keep both (batch 2B).
* Refusal: at w != 1 both engines raise the same message, before the
  port's UNet runs.
"""

import numpy as np
import pytest

from cfgpp_tpu.engine.pipeline import _needs_branches as jax_needs_branches
from cfgpp_tpu.schedules.ddim import make_ddim_schedule as jax_schedule
from cfgpp_tpu.solvers import registry as jax_registry
from cfgpp_tpu_torch.engine import DiffusionEngine
from cfgpp_tpu_torch.schedules.ddim import make_ddim_schedule
from cfgpp_tpu_torch.solvers import registry
from tests.test_torch_port_sdxl_engine import (NFE, PROMPT, Engines, hold,
                                               run_both)
from tests.test_torch_port_sdxl_solvers import LIGHTNING, SPEC_FIELDS

SINGLE_BRANCH = ("ddim_lightning", "euler_lightning")
REFUSAL = "CFG should be turned off (cfg_guidance=1) in the lightning version"


@pytest.fixture(scope="module")
def engines():
    return Engines()


def test_sdxl_solver_list_equals_jax():
    assert registry.list_solvers("sdxl") == jax_registry.list_solvers("sdxl")
    assert sorted(LIGHTNING) == sorted(SINGLE_BRANCH + (
        "euler_cfg++_lightning", "ddim_cfg++_lightning",
        "dpm++_2m_cfgpp_lightning"))


@pytest.mark.parametrize("nfe", [4, 8])
@pytest.mark.parametrize("name", LIGHTNING)
def test_lightning_plans_equal(name, nfe):
    want_spec = jax_registry.get_solver_spec(name, "sdxl")
    spec = registry.get_solver_spec(name, "sdxl")
    assert [getattr(spec, f) for f in SPEC_FIELDS] == [
        getattr(want_spec, f) for f in SPEC_FIELDS]
    assert spec.plan_fn.__name__ == want_spec.plan_fn.__name__
    want = want_spec.plan_fn(jax_schedule(nfe, timestep_spacing="trailing"))
    got = spec.plan_fn(make_ddim_schedule(nfe, timestep_spacing="trailing"))
    for field in ("n_steps", "init", "init_scale", "needs_noise", "final",
                  "tail_coeffs"):
        assert getattr(got, field) == getattr(want, field), field
    assert sorted(got.coeffs) == sorted(want.coeffs)
    for k in want.coeffs:
        assert got.coeffs[k].dtype == want.coeffs[k].dtype, k
        np.testing.assert_array_equal(got.coeffs[k], want.coeffs[k], err_msg=k)


def unet_batches(engine):
    """A list that records the batch of every UNet call of ``engine``."""
    seen = []
    handle = engine.bundle.unet.register_forward_pre_hook(
        lambda module, args: seen.append(args[0].shape[0]))
    return seen, handle


@pytest.mark.parametrize("name", LIGHTNING)
def test_lightning_engine_matches_jax_at_w1(engines, name):
    got, want = run_both(engines, name, 1.0, PROMPT)
    hold(got, want, f"{name} w=1")


@pytest.mark.parametrize("name", LIGHTNING)
def test_branches_at_w1(engines, name):
    spec = registry.get_solver_spec(name, "sdxl")
    single = name in SINGLE_BRANCH
    assert jax_needs_branches(spec.cfgpp, 1.0) == (
        (False, True) if single else (True, True))
    engine = DiffusionEngine(engines.bundle, name, nfe=NFE)
    seen, handle = unet_batches(engine)
    try:
        engine.sample(PROMPT, cfg_guidance=1.0, resolution=16,
                      init_latent_override=np.zeros((1, 8, 8, 4), np.float32))
    finally:
        handle.remove()
    assert seen == [1 if single else 2] * engine.plan.n_steps


@pytest.mark.parametrize("w", [5.0, 0.0])
def test_refusal_equals_jax_before_any_unet_call(engines, w):
    name = "ddim_cfg++_lightning"
    with pytest.raises(ValueError) as want:
        engines.jax(name).sample(PROMPT, cfg_guidance=w, resolution=16)
    engine = DiffusionEngine(engines.bundle, name, nfe=NFE)
    seen, handle = unet_batches(engine)
    try:
        with pytest.raises(ValueError) as got:
            engine.sample(PROMPT, cfg_guidance=w, resolution=16)
    finally:
        handle.remove()
    assert str(got.value) == str(want.value) == REFUSAL
    assert seen == []
