"""SD3's flow-matching schedule and solvers in the port
(``schedules/flow.py``, ``solvers/plans.py:plan_flow_euler``,
``solvers/steps.py:flow_euler_step``, the ``sd3`` registry table): the
28-step sigma table of SD3.5 Large against diffusers' recipe written out,
each step against its equations, and CFG++ against CFG where the two
velocities agree (float32 arithmetic on both sides, hence 1e-6)."""

import numpy as np
import pytest
import torch

from cfgpp_tpu_torch.schedules.flow import make_flow_schedule
from cfgpp_tpu_torch.solvers import registry, sampler, steps

SHIFT = 3.0


def shifted(u):
    return SHIFT * u / (1 + (SHIFT - 1) * u)


def test_the_28_step_table():
    """sigma_min = 3 0.001 / (1 + 2 0.001); t_i = linspace(1000, 1000
    sigma_min, 28); sigma_i = 3u / (1 + 2u), u = t_i / 1000; sigma_28 = 0;
    the model is fed 1000 sigma_i."""
    sch = make_flow_schedule(28, SHIFT, 1000)
    sigma_min = 3 * 0.001 / (1 + 2 * 0.001)
    t = np.linspace(1000, 1000 * sigma_min, 28)
    want = [3 * (x / 1000) / (1 + 2 * (x / 1000)) for x in t] + [0.0]
    np.testing.assert_allclose(sch.sigmas, want, rtol=1e-15, atol=0)
    np.testing.assert_allclose(sch.timesteps, 1000 * np.array(want[:-1]),
                               rtol=1e-15)
    assert sch.sigmas[0] == 1.0 and sch.sigmas[-1] == 0.0
    assert np.all(np.diff(sch.sigmas) < 0)
    assert sch.sigmas[27] == pytest.approx(shifted(shifted(0.001)))


def test_the_registry_table():
    assert registry.list_solvers("sd3") == ["flow_euler", "flow_euler_cfg++"]
    for name, cfgpp in (("flow_euler", False), ("flow_euler_cfg++", True)):
        spec = registry.get_solver_spec(name, "sd3")
        assert (spec.kind, spec.cfgpp, spec.family) == ("flow", cfgpp, "sd3")
        plan = spec.plan_fn(make_flow_schedule(28))
        assert plan.n_steps == 28 and plan.final == "x"
        assert plan.init_scale == 1.0 and not plan.needs_noise
        np.testing.assert_array_equal(plan.coeffs["sigma"][1:],
                                      plan.coeffs["sigma_next"][:-1])


def velocity(scale_c):
    """A velocity pair linear in x: v_uc = 0.3 x - 0.1, v_c = scale_c *
    v_uc + 0.05 (scale_c 1 and the offset 0: v_c = v_uc)."""
    def fn(x, t):
        v_uc = 0.3 * x - 0.1 + 1e-4 * t
        return v_uc, scale_c * v_uc + (0.0 if scale_c == 1 else 0.05)
    return fn


def run(name, fn, w, nfe=6):
    spec = registry.get_solver_spec(name, "sd3")
    plan = spec.plan_fn(make_flow_schedule(nfe))
    x = torch.randn(1, 4, 4, 16, generator=torch.Generator().manual_seed(0))
    return sampler.run_solver(spec, plan, fn, x, w)[0], plan, x


@pytest.mark.parametrize("w", [0.6, 1.0, 3.5])
def test_cfgpp_is_euler_where_the_velocities_agree(w):
    got, _, _ = run("flow_euler_cfg++", velocity(1), w)
    want, _, _ = run("flow_euler", velocity(1), w)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_cfgpp_renoises_with_the_unconditional_velocity():
    """Where v_c differs, each CFG++ step is x0 = x - s v_w, x_next = (1 -
    s') x0 + s' (x + (1 - s) v_uc), written out step by step; it differs
    from the CFG Euler step."""
    fn, w = velocity(1.7), 0.6
    got, plan, x = run("flow_euler_cfg++", fn, w)
    for s, s_next, t in zip(plan.coeffs["sigma"], plan.coeffs["sigma_next"],
                            plan.coeffs["t"]):
        v_uc, v_c = fn(x, torch.tensor(t))
        v_w = v_uc + w * (v_c - v_uc)
        x0 = x - float(s) * v_w
        x = (1 - float(s_next)) * x0 + float(s_next) * (x + (1 - float(s))
                                                        * v_uc)
    torch.testing.assert_close(got, x, rtol=1e-6, atol=1e-6)
    euler, _, _ = run("flow_euler", fn, w)
    assert (euler - got).abs().max() > 1e-3


def test_cfg_is_diffusers_euler_step():
    """x_next = x + (sigma_next - sigma) v_w, and the step's x0 = x - sigma
    v_w."""
    x = torch.randn(2, 3, 3, 16, generator=torch.Generator().manual_seed(1))
    c = {"t": torch.tensor(500.0), "sigma": torch.tensor(0.5),
         "sigma_next": torch.tensor(0.4)}
    fn = velocity(1.3)
    x_next, x0 = steps.flow_euler_step(fn, 3.5, c, x, cfgpp=False)
    v_uc, v_c = fn(x, c["t"])
    v_w = v_uc + 3.5 * (v_c - v_uc)
    torch.testing.assert_close(x_next, x - 0.1 * v_w)
    torch.testing.assert_close(x0, x - 0.5 * v_w)
