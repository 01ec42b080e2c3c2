"""The port's DDIM solver pieces against cfgpp_tpu.solvers.

Plans are host numpy in both packages and must be identical.  The step and
the loop run a synthetic eps function written once for each framework on
the same numpy inputs; tolerance 1e-6 abs for one step (f32 on both sides,
same formula) and 1e-5 relative to the latent scale over a whole loop,
where f32 rounding differences are amplified by 1/sqrt(alpha_t).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgpp_tpu.schedules.ddim import make_ddim_schedule
from cfgpp_tpu.solvers import plans as jax_plans
from cfgpp_tpu.solvers import registry as jax_registry
from cfgpp_tpu.solvers import sampler as jax_sampler
from cfgpp_tpu.solvers import steps as jax_steps
from cfgpp_tpu_torch.solvers import plans, registry, sampler, steps


def _eps_jax(z, t):
    tt = jnp.asarray(t, jnp.float32) * 0.001
    return 0.05 * z + jnp.sin(tt), -0.03 * z + jnp.cos(2.0 * tt)


def _eps_torch(z, t):
    tt = torch.as_tensor(t, dtype=torch.float32) * 0.001
    return 0.05 * z + torch.sin(tt), -0.03 * z + torch.cos(2.0 * tt)


@pytest.mark.parametrize("nfe", [50, 4])
def test_plan_ddim_tables_equal(nfe):
    sched = make_ddim_schedule(nfe)
    want, got = jax_plans.plan_ddim(sched), plans.plan_ddim(sched)
    assert (got.n_steps, got.init, got.init_scale, got.needs_noise, got.final) == (
        want.n_steps, want.init, want.init_scale, want.needs_noise, want.final)
    assert sorted(got.coeffs) == sorted(want.coeffs)
    for k in want.coeffs:
        assert got.coeffs[k].dtype == want.coeffs[k].dtype
        np.testing.assert_array_equal(got.coeffs[k], want.coeffs[k])


@pytest.mark.parametrize("name", ["ddim", "ddim_cfg++"])
def test_registry_specs_match(name):
    want, got = (jax_registry.get_solver_spec(name, "sd"),
                 registry.get_solver_spec(name, "sd"))
    assert (got.name, got.family, got.kind, got.cfgpp, got.timestep_spacing) == (
        want.name, want.family, want.kind, want.cfgpp, want.timestep_spacing)
    with pytest.raises(ValueError, match="does not exist"):
        registry.get_solver_spec("dpm++_2m", "sd")


@pytest.mark.parametrize("cfgpp", [False, True])
@pytest.mark.parametrize("row", [0, 17, 49])
def test_ddim_step_matches_jax(cfgpp, row):
    plan = plans.plan_ddim(make_ddim_schedule(50))
    c = {k: v[row] for k, v in plan.coeffs.items()}
    z = np.random.default_rng(row).standard_normal((2, 8, 8, 4)).astype(np.float32)
    w = 0.6 if cfgpp else 7.5
    want_zt, want_z0 = jax_steps.ddim_step(
        _eps_jax, jnp.float32(w), {k: jnp.asarray(v) for k, v in c.items()},
        jnp.asarray(z), cfgpp=cfgpp)
    got_zt, got_z0 = steps.ddim_step(
        _eps_torch, torch.tensor(w), {k: torch.as_tensor(v) for k, v in c.items()},
        torch.from_numpy(z), cfgpp=cfgpp)
    np.testing.assert_allclose(got_zt.numpy(), np.asarray(want_zt), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_z0.numpy(), np.asarray(want_z0), atol=1e-6, rtol=0)


def test_cfg_mix():
    uc, c = torch.tensor([1.0, -2.0]), torch.tensor([3.0, 0.5])
    assert torch.allclose(steps.cfg_mix(uc, c, 0.6), uc + 0.6 * (c - uc))


@pytest.mark.parametrize("name,w", [("ddim", 7.5), ("ddim_cfg++", 0.6)])
def test_run_solver_trajectory_matches_jax(name, w):
    spec, jspec = (registry.get_solver_spec(name),
                   jax_registry.get_solver_spec(name))
    plan = spec.plan_fn(make_ddim_schedule(10))
    zT = np.random.default_rng(1).standard_normal((1, 8, 8, 4)).astype(np.float32)
    want, (wz0, wzt) = jax_sampler.run_solver(jspec, jax_plans.plan_ddim(
        make_ddim_schedule(10)), _eps_jax, jnp.asarray(zT), w,
        return_trajectory=True)
    got, (gz0, gzt) = sampler.run_solver(spec, plan, _eps_torch,
                                         torch.from_numpy(zT), w,
                                         return_trajectory=True)
    assert gz0.shape == wz0.shape == (10, 1, 8, 8, 4)
    for g, x in ((got, want), (gz0, wz0), (gzt, wzt)):
        x = np.asarray(x)
        np.testing.assert_allclose(g.numpy(), x, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(x).max())))
    assert sampler.run_solver(spec, plan, _eps_torch, torch.from_numpy(zT),
                              w)[1] is None


def test_init_latent_seeded():
    plan = plans.plan_ddim(make_ddim_schedule(4))
    draw = [sampler.init_latent(plan, torch.Generator().manual_seed(s),
                                (1, 8, 8, 4)) for s in (3, 3, 4)]
    assert draw[0].shape == (1, 8, 8, 4) and draw[0].dtype == torch.float32
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])
