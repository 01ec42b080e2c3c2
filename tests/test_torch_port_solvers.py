"""The port's solver pieces against cfgpp_tpu.solvers.

Plans are host numpy in both packages and must be identical, array by
array and dtype by dtype.  The steps and the loops run a synthetic eps
function written once for each framework on the same numpy inputs;
tolerance 1e-6 abs for one step (f32 on both sides, same formula; relative
to the output's scale where it exceeds 1) and 1e-5 relative to the latent
scale over a whole loop, where f32 rounding
differences are amplified by 1/sqrt(alpha_t) (DDIM) or by the VE scale
sigma (k-diffusion).  The ancestral loops get the JAX package's own noise
(``jax.random.normal(fold_in(key, i))``, as its sampler draws it) through
``noise_fn``.

The last test holds the port's engine on tiny_sd against the JAX engine at
16^2, NFE 4, f32, for every sampling solver, with zT and the per-step noise
injected (``init_latent_override``, ``noise_override``: the frameworks'
random streams differ); per-step (z0t, zt) and the image agree to 1e-4 x
max(1, scale), the rule of ``tests/test_torch_port_engine.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgpp_tpu.engine import DiffusionEngine as JaxEngine
from cfgpp_tpu.engine import ModelBundle as JaxBundle
from cfgpp_tpu.schedules.ddim import make_ddim_schedule
from cfgpp_tpu.solvers import plans as jax_plans
from cfgpp_tpu.solvers import registry as jax_registry
from cfgpp_tpu.solvers import sampler as jax_sampler
from cfgpp_tpu.solvers import steps as jax_steps
from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
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


PLANS = ["plan_ddim_inversion", "plan_euler", "plan_euler_ancestral",
         "plan_dpmpp_2s_ancestral", "plan_dpmpp_2m"]


@pytest.mark.parametrize("nfe", [50, 10, 4])
@pytest.mark.parametrize("plan_fn", PLANS)
def test_plan_tables_equal(plan_fn, nfe):
    sched = make_ddim_schedule(nfe)
    want = getattr(jax_plans, plan_fn)(sched)
    got = getattr(plans, plan_fn)(sched)
    assert (got.n_steps, got.init, got.init_scale, got.needs_noise, got.final,
            got.tail_coeffs) == (want.n_steps, want.init, want.init_scale,
                                 want.needs_noise, want.final, want.tail_coeffs)
    assert sorted(got.coeffs) == sorted(want.coeffs)
    for k in want.coeffs:
        assert got.coeffs[k].dtype == want.coeffs[k].dtype, k
        np.testing.assert_array_equal(got.coeffs[k], want.coeffs[k], err_msg=k)


def test_list_solvers_equal():
    assert registry.list_solvers("sd") == jax_registry.list_solvers("sd")
    assert len(registry.list_solvers("sd")) == 15


SPEC_FIELDS = ("name", "family", "kind", "cfgpp", "diff_cfgpp_uses_uncond",
               "lightning", "inversion", "edit", "timestep_spacing")


@pytest.mark.parametrize("name", jax_registry.list_solvers("sd"))
def test_registry_specs_match(name):
    want, got = (jax_registry.get_solver_spec(name, "sd"),
                 registry.get_solver_spec(name, "sd"))
    assert [getattr(got, f) for f in SPEC_FIELDS] == [
        getattr(want, f) for f in SPEC_FIELDS]
    assert got.plan_fn.__name__ == want.plan_fn.__name__
    with pytest.raises(ValueError, match="does not exist.*dpm\\+\\+_2m_cfg\\+\\+"):
        registry.get_solver_spec("dpm++_3m", "sd")


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


def _row(plan, i):
    return ({k: jnp.asarray(v[i]) for k, v in plan.coeffs.items()},
            {k: torch.as_tensor(v[i]) for k, v in plan.coeffs.items()})


def _assert_pairs(got, want):
    """1e-6 abs at unit scale: the VE steps' outputs reach tens (sigma up to
    14.6), where one f32 ulp is already a few 1e-6."""
    for g, x in zip(got, want):
        x = np.asarray(x)
        np.testing.assert_allclose(g.numpy(), x, rtol=0,
                                   atol=1e-6 * max(1.0, float(np.abs(x).max())))


# (step function, plan, needs noise).  Rows: first, middle and last step.
STEPS = {
    "ddim_inversion_step": ("plan_ddim_inversion", False),
    "euler_step": ("plan_euler", False),
    "euler_ancestral_step": ("plan_euler_ancestral", True),
    "dpmpp_2s_ancestral_step": ("plan_dpmpp_2s_ancestral", True),
}


@pytest.mark.parametrize("cfgpp", [False, True])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("step", sorted(STEPS))
def test_step_matches_jax(step, where, cfgpp):
    plan_fn, noisy = STEPS[step]
    plan = getattr(plans, plan_fn)(make_ddim_schedule(50))
    row = {"first": 0, "middle": plan.n_steps // 3, "last": plan.n_steps - 1}[where]
    cj, ct = _row(plan, row)
    rng = np.random.default_rng(row)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32) * 3.0
    noise = rng.standard_normal(z.shape).astype(np.float32)
    w = 0.6 if cfgpp else 7.5
    extra_j = (jnp.asarray(noise),) if noisy else ()
    extra_t = (torch.from_numpy(noise),) if noisy else ()
    want = getattr(jax_steps, step)(_eps_jax, jnp.float32(w), cj,
                                    jnp.asarray(z), *extra_j, cfgpp=cfgpp)
    got = getattr(steps, step)(_eps_torch, torch.tensor(w), ct,
                               torch.from_numpy(z), *extra_t, cfgpp=cfgpp)
    _assert_pairs(got, want)


def test_euler_ancestral_adds_no_noise_at_sigma_zero():
    """The last step has sigma_next == 0: no noise term at all, so even a
    non-finite draw leaves x_next finite (a zero sigma_up alone would not)."""
    plan = plans.plan_euler_ancestral(make_ddim_schedule(10))
    cj, ct = _row(plan, plan.n_steps - 1)
    assert float(ct["sigma_next"]) == 0.0
    z = np.random.default_rng(3).standard_normal((1, 8, 8, 4)).astype(np.float32)
    noise = np.full(z.shape, np.inf, np.float32)
    want = jax_steps.euler_ancestral_step(_eps_jax, jnp.float32(7.5), cj,
                                          jnp.asarray(z), jnp.asarray(noise),
                                          cfgpp=False)
    got = steps.euler_ancestral_step(_eps_torch, torch.tensor(7.5), ct,
                                     torch.from_numpy(z), torch.from_numpy(noise),
                                     cfgpp=False)
    assert bool(torch.isfinite(got[0]).all())
    _assert_pairs(got, want)


@pytest.mark.parametrize("cfgpp", [False, True])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("uncond_diff", [False, True])
def test_dpmpp_2m_step_matches_jax(uncond_diff, where, cfgpp):
    """The 2M step with its carry: row 0 takes the euler branch, the others
    the multistep one; ``diff_cfgpp_uses_uncond`` (SDXL's form) too."""
    plan = plans.plan_dpmpp_2m(make_ddim_schedule(50))
    row = {"first": 0, "middle": 17, "last": plan.n_steps - 1}[where]
    cj, ct = _row(plan, row)
    rng = np.random.default_rng(row)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32) * 3.0
    old = rng.standard_normal(x.shape).astype(np.float32)
    w = 0.6 if cfgpp else 7.5
    (wx, wold), wden = jax_steps.dpmpp_2m_step(
        _eps_jax, jnp.float32(w), cj, (jnp.asarray(x), jnp.asarray(old)),
        cfgpp=cfgpp, diff_cfgpp_uses_uncond=uncond_diff)
    (gx, gold), gden = steps.dpmpp_2m_step(
        _eps_torch, torch.tensor(w), ct,
        (torch.from_numpy(x), torch.from_numpy(old)), cfgpp=cfgpp,
        diff_cfgpp_uses_uncond=uncond_diff)
    _assert_pairs((gx, gold, gden), (wx, wold, wden))


@pytest.mark.parametrize("cfgpp", [False, True])
def test_dpmpp_2s_tail_step_matches_jax(cfgpp):
    plan = plans.plan_dpmpp_2s_ancestral(make_ddim_schedule(50))
    x = np.random.default_rng(5).standard_normal((2, 8, 8, 4)).astype(np.float32)
    w = 0.6 if cfgpp else 7.5
    want = jax_steps.dpmpp_2s_tail_step(_eps_jax, jnp.float32(w),
                                        plan.tail_coeffs, jnp.asarray(x),
                                        cfgpp=cfgpp)
    got = steps.dpmpp_2s_tail_step(_eps_torch, torch.tensor(w),
                                   plan.tail_coeffs, torch.from_numpy(x),
                                   cfgpp=cfgpp)
    _assert_pairs(got, want)


SAMPLING = [n for n in jax_registry.list_solvers("sd")
            if not jax_registry.get_solver_spec(n).inversion]


def _jax_noise_fn(key):
    """noise_fn returning the JAX sampler's own per-step draws."""
    def noise_fn(i, like):
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(key, i), tuple(like.shape), jnp.float32)))
    return noise_fn


@pytest.mark.parametrize("name", SAMPLING)
def test_run_solver_every_kind_matches_jax(name):
    spec, jspec = registry.get_solver_spec(name), jax_registry.get_solver_spec(name)
    sched = make_ddim_schedule(10)
    plan, jplan = spec.plan_fn(sched), jspec.plan_fn(sched)
    w = 0.6 if spec.cfgpp else 7.5
    zT = (np.random.default_rng(1).standard_normal((1, 8, 8, 4)).astype(np.float32)
          * plan.init_scale)
    key = jax.random.PRNGKey(7)
    want, (wz0, wzt) = jax_sampler.run_solver(
        jspec, jplan, _eps_jax, jnp.asarray(zT), w,
        noise_key=key if jplan.needs_noise else None, return_trajectory=True)
    got, (gz0, gzt) = sampler.run_solver(
        spec, plan, _eps_torch, torch.from_numpy(zT), w,
        noise_fn=_jax_noise_fn(key) if plan.needs_noise else None,
        return_trajectory=True)
    assert gz0.shape == np.shape(wz0) == (plan.n_steps, 1, 8, 8, 4)
    for g, x in ((got, want), (gz0, wz0), (gzt, wzt)):
        x = np.asarray(x)
        np.testing.assert_allclose(g.numpy(), x, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(x).max())))


@pytest.mark.parametrize("name,w", [("ddim_inversion", 1.0), ("ddim_inversion", 7.5),
                                    ("ddim_inversion_cfg++", 0.6)])
def test_run_inversion_matches_jax(name, w):
    spec, jspec = registry.get_solver_spec(name), jax_registry.get_solver_spec(name)
    sched = make_ddim_schedule(10)
    z0 = np.random.default_rng(2).standard_normal((1, 8, 8, 4)).astype(np.float32)
    want = jax_sampler.run_inversion(jspec, jax_plans.plan_ddim_inversion(sched),
                                     _eps_jax, jnp.asarray(z0), w)
    got = sampler.run_inversion(spec, plans.plan_ddim_inversion(sched),
                                _eps_torch, torch.from_numpy(z0), w)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


def test_noise_and_guidance_checks():
    z = torch.zeros((1, 8, 8, 4))
    for name in ("euler_a", "dpm++_2s_a_cfg++"):
        spec = registry.get_solver_spec(name)
        with pytest.raises(ValueError, match="ancestral and needs a noise_fn"):
            sampler.run_solver(spec, spec.plan_fn(make_ddim_schedule(4)),
                               _eps_torch, z, 0.6)
    light = dataclasses.replace(registry.get_solver_spec("ddim"), lightning=True)
    plan = light.plan_fn(make_ddim_schedule(4))
    with pytest.raises(ValueError, match="cfg_guidance=1"):
        sampler.run_solver(light, plan, _eps_torch, z, 7.5)
    assert sampler.run_solver(light, plan, _eps_torch, z, 1.0)[0].shape == z.shape


def test_ancestral_noise_is_per_step():
    """Step i's noise comes from noise_fn(i, ...), called once per step in
    order; the loop asks for nothing else."""
    spec = registry.get_solver_spec("euler_a")
    plan = spec.plan_fn(make_ddim_schedule(6))
    asked = []

    def noise_fn(i, like):
        asked.append(i)
        return torch.zeros_like(like)

    sampler.run_solver(spec, plan, _eps_torch, torch.ones((1, 8, 8, 4)), 7.5,
                       noise_fn=noise_fn)
    assert asked == list(range(6))


@pytest.fixture(scope="module")
def bundles():
    jb = JaxBundle.random_init("tiny_sd", seed=0, dtype=jnp.float32,
                               param_dtype=jnp.float32)
    tb = ModelBundle.from_flax("tiny_sd", jb.params(), dtype=torch.float32,
                               device="cpu")
    return jb, tb


def _assert_close(got, want, what, tol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= tol * max(1.0, scale), f"{what}: max err {err} (scale {scale})"


@pytest.mark.parametrize("name", [n for n in SAMPLING if not n.startswith("ddim")])
def test_engine_every_sampling_solver_matches_jax(bundles, name):
    jb, tb = bundles
    seed, nfe = 5, 4
    jeng, eng = JaxEngine(jb, name, nfe=nfe), DiffusionEngine(tb, name, nfe=nfe)
    n_steps = eng.plan.n_steps
    zT = (np.random.default_rng(0).standard_normal((1, 8, 8, 4)).astype(np.float32)
          * eng.plan.init_scale)
    # the JAX engine's per-step noise: fold_in(split(PRNGKey(seed), 3)[1], i)
    k_noise = jax.random.split(jax.random.PRNGKey(seed), 3)[1]
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(k_noise, i), zT.shape, jnp.float32))
        for i in range(n_steps)])
    w = 0.6 if eng.spec.cfgpp else 7.5
    kw = dict(cfg_guidance=w, seed=seed, resolution=16,
              init_latent_override=zT, return_trajectory=True)
    want_img, (want_z0, want_zt) = jeng.sample(["", "a cat"], **kw)
    img, (z0s, zts) = eng.sample(
        ["", "a cat"], noise_override=noise if eng.plan.needs_noise else None, **kw)
    assert z0s.shape == zts.shape == (n_steps, 1, 8, 8, 4)
    for i in range(n_steps):
        _assert_close(z0s[i], want_z0[i], f"z0t step {i}")
        _assert_close(zts[i], want_zt[i], f"zt step {i}")
    _assert_close(img, want_img, "image")


def test_engine_noise_is_seeded_per_step(bundles):
    """Without ``noise_override`` the engine draws step i's noise from a
    generator seeded from (seed, i): the same whatever was drawn before it,
    the same for the same seed, and another for another seed."""
    _, tb = bundles
    eng = DiffusionEngine(tb, "euler_a", nfe=4)
    like = torch.zeros((1, 8, 8, 4))
    fresh, used = eng._noise_fn(7, like, None), eng._noise_fn(7, like, None)
    used(0, like), used(1, like)
    assert torch.equal(fresh(2, like), used(2, like))
    assert not torch.equal(fresh(2, like), fresh(3, like))
    zT = np.random.default_rng(0).standard_normal((1, 8, 8, 4)).astype(np.float32)
    imgs = [eng.sample(["", "a cat"], seed=s, resolution=16,
                       init_latent_override=zT * eng.plan.init_scale)
            for s in (1, 1, 2)]
    assert torch.equal(imgs[0], imgs[1]) and not torch.equal(imgs[0], imgs[2])
