"""The port's SDXL solver plans and registry against cfgpp_tpu's.

Plans are host numpy on both sides, so they are held equal array by array
(dtype and value) at NFE 25 (the main path), 10 and 4.  The registry's
SDXL specs are held equal field by field, plan function included, for
every name; the 5 SDXL-Lightning names are SDXL solvers only, as in JAX
(tests/test_torch_port_lightning.py holds their plans and engine).
"""

import numpy as np
import pytest

from cfgpp_tpu.schedules.ddim import make_ddim_schedule as jax_schedule
from cfgpp_tpu.solvers import plans as jax_plans
from cfgpp_tpu.solvers import registry as jax_registry
from cfgpp_tpu_torch.schedules.ddim import make_ddim_schedule
from cfgpp_tpu_torch.solvers import plans, registry

SPEC_FIELDS = ("name", "family", "kind", "cfgpp", "diff_cfgpp_uses_uncond",
               "lightning", "inversion", "edit", "timestep_spacing")
JAX_SDXL = jax_registry.list_solvers("sdxl")
LIGHTNING = [n for n in JAX_SDXL
             if jax_registry.get_solver_spec(n, "sdxl").lightning]


@pytest.mark.parametrize("nfe", [25, 10, 4])
@pytest.mark.parametrize("name", ["plan_dpmpp_2m_vp_sdxl",
                                  "plan_euler_vp_sigmas_sdxl"])
def test_sdxl_plans_equal(name, nfe):
    want = getattr(jax_plans, name)(jax_schedule(nfe))
    got = getattr(plans, name)(make_ddim_schedule(nfe))
    for field in ("n_steps", "init", "init_scale", "needs_noise", "final",
                  "tail_coeffs"):
        assert getattr(got, field) == getattr(want, field), field
    assert sorted(got.coeffs) == sorted(want.coeffs)
    for k in want.coeffs:
        assert got.coeffs[k].dtype == want.coeffs[k].dtype, k
        np.testing.assert_array_equal(got.coeffs[k], want.coeffs[k], err_msg=k)
    if name == "plan_dpmpp_2m_vp_sdxl":
        assert got.n_steps == nfe - 1     # loops timesteps[:-1]


def test_sdxl_list_is_the_jax_list_without_lightning():
    """The SDXL list without its Lightning names is the JAX list without
    them, and with them it is the JAX list."""
    assert len(LIGHTNING) == 5
    assert sorted(set(registry.list_solvers("sdxl")) - set(LIGHTNING)) == \
        sorted(set(JAX_SDXL) - set(LIGHTNING))
    assert registry.list_solvers("sdxl") == JAX_SDXL
    # 12 solvers and the dpm++_2m_cfg++ alias
    assert len(registry.list_solvers("sdxl")) == 13
    assert registry.list_solvers("sd") == jax_registry.list_solvers("sd")


@pytest.mark.parametrize("name", sorted(set(JAX_SDXL) - set(LIGHTNING)))
def test_sdxl_specs_match(name):
    want = jax_registry.get_solver_spec(name, "sdxl")
    got = registry.get_solver_spec(name, "sdxl")
    assert [getattr(got, f) for f in SPEC_FIELDS] == [
        getattr(want, f) for f in SPEC_FIELDS]
    assert got.plan_fn.__name__ == want.plan_fn.__name__


def test_sdxl_alias_is_the_same_spec():
    assert registry.get_solver_spec("dpm++_2m_cfg++", "sdxl") is \
        registry.get_solver_spec("dpm++_2m_cfgpp", "sdxl")
    assert registry.get_solver_spec("dpm++_2m_cfg++", "sd") is not \
        registry.get_solver_spec("dpm++_2m_cfgpp", "sdxl")


@pytest.mark.parametrize("name", LIGHTNING)
def test_lightning_names_raise(name):
    """Each Lightning spec equals JAX's (lightning, trailing spacing, its
    plan function); the name raises in the SD family, as in JAX."""
    want = jax_registry.get_solver_spec(name, "sdxl")
    got = registry.get_solver_spec(name, "sdxl")
    assert [getattr(got, f) for f in SPEC_FIELDS] == [
        getattr(want, f) for f in SPEC_FIELDS]
    assert got.lightning and got.timestep_spacing == "trailing"
    assert got.plan_fn.__name__ == want.plan_fn.__name__
    for table in (registry, jax_registry):
        with pytest.raises(ValueError, match="does not exist"):
            table.get_solver_spec(name, "sd")


def test_unknown_names_and_families_raise():
    with pytest.raises(ValueError, match="does not exist for family 'sdxl'"
                       ".*dpm\\+\\+_2m_cfgpp"):
        registry.get_solver_spec("euler_a", "sdxl")
    with pytest.raises(ValueError, match="unknown model family"):
        registry.list_solvers("flux")
