"""The port's SDXL DiffusionEngine against cfgpp_tpu's, on ``tiny_sdxl``.

Weights and bridge as in tests/test_torch_port_sdxl_models.py; the same zT
(or, for the edit solvers, the same encoded source latent) injected into
both engines.  This file runs the one-prompt sampling solvers of the SDXL
table at their reference guidance (w=5 for the main path
``dpm++_2m_cfgpp``, 7.5 for plain CFG, lambda=0.6 for CFG++) and the
``dpm++_2m_cfg++`` alias, with ``prompt_2`` different from ``prompt``,
non-default micro-conditioning (``original_size``,
``crops_coords_top_left``, ``target_size``) and the conditional branch
alone (w=1 under plain ``ddim``); tests/test_torch_port_sdxl_edit.py runs
the edit solvers (three prompts), and ``ddim_cfg++`` with ``clip_skip``
and the unconditional branch alone (w=0).  Requests that differ only in their
inputs share one JAX engine (one compile): the alias is held against the
JAX engine of the name it stands for, after its spec is checked to be the
same object in both tables.

Tolerance: every step's (z0t, zt) and the image within 1e-4 x max(1,
scale), the rule of tests/test_torch_port_engine.py (f32 on both sides).
"""

import numpy as np
import pytest
import torch

from cfgpp_tpu.engine import DiffusionEngine as JaxEngine
from cfgpp_tpu.solvers import registry as jax_registry
from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
from cfgpp_tpu_torch.solvers import registry
from tests.test_torch_port_sdxl_models import _assert_close, jax_tiny_sdxl

NFE = 4
EXACT_TOL = 1e-4
PROMPT = ["", "a photo of a cat"]
EDIT_PROMPT = ["", "a photo of a cat", "a photo of a dog"]
MICRO = dict(original_size=(1024, 768), crops_coords_top_left=(16, 32),
             target_size=(512, 512))


class Engines:
    """The tiny_sdxl bundles and one JAX engine per solver name (each
    compiles once per guidance mode and clip_skip)."""

    def __init__(self):
        self.jax_bundle = jax_tiny_sdxl()
        self.bundle = ModelBundle.from_flax(
            "tiny_sdxl", self.jax_bundle.params(), dtype=torch.float32,
            device="cpu")
        self._jax = {}

    def jax(self, solver):
        if solver not in self._jax:
            self._jax[solver] = JaxEngine(self.jax_bundle, solver, nfe=NFE)
        return self._jax[solver]


@pytest.fixture(scope="module")
def engines():
    return Engines()


def request(solver, batch=1):
    """The injected latent of a request: zT, or the edit's source image and
    its encoded latent."""
    rng = np.random.default_rng(11)
    kw = dict(resolution=16, return_trajectory=True)
    if "edit" in solver:
        kw.update(src_img=rng.uniform(-1, 1, (batch, 16, 16, 3)).astype(
            np.float32), src_latent_override=rng.standard_normal(
            (batch, 8, 8, 4)).astype(np.float32))
    else:
        kw["init_latent_override"] = rng.standard_normal(
            (batch, 8, 8, 4)).astype(np.float32)
    return kw


def hold(got, want, what, tol=EXACT_TOL):
    img, (z0s, zts) = got
    want_img, (want_z0, want_zt) = want
    n = np.asarray(want_z0).shape[0]
    assert z0s.shape[0] == zts.shape[0] == n, (what, z0s.shape, n)
    assert img.dtype == torch.float32
    for i in range(n):
        _assert_close(z0s[i], want_z0[i], f"{what} z0t step {i}", tol)
        _assert_close(zts[i], want_zt[i], f"{what} zt step {i}", tol)
    _assert_close(img, want_img, f"{what} image", tol)


def run_both(engines, solver, w, prompt, jax_solver=None, **extra):
    kw = dict(request(solver), cfg_guidance=w, **extra)
    want = engines.jax(jax_solver or solver).sample(prompt, **kw)
    got = DiffusionEngine(engines.bundle, solver, nfe=NFE).sample(prompt,
                                                                  **kw)
    return got, want


@pytest.mark.parametrize("solver,w,extra", [
    ("dpm++_2m_cfgpp", 5.0, {}),      # the main path (bench.py:72)
    ("dpm++_2m_cfgpp", 5.0, {"prompt_2": ["blurry", "an oil painting"]}),
    ("dpm++_2m_cfg++", 5.0, {}),      # the alias
    ("euler_cfg++", 0.6, {}),
    ("euler_cfg++", 0.6, MICRO),
    ("euler", 7.5, {}),
    ("ddim", 1.0, MICRO),             # the conditional branch alone
], ids=["main", "prompt_2", "alias", "euler_cfg++", "micro", "euler", "w1"])
def test_sampling_matches_jax(engines, solver, w, extra):
    jax_solver = registry.get_solver_spec(solver, "sdxl").name
    assert jax_registry.get_solver_spec(solver, "sdxl") is \
        jax_registry.get_solver_spec(jax_solver, "sdxl")
    got, want = run_both(engines, solver, w, PROMPT, jax_solver, **extra)
    hold(got, want, f"{solver} w={w} {sorted(extra)}")


def test_options_move_the_result(engines):
    """prompt_2 and the micro-conditioning reach the UNet: the port's first
    z0t moves with each (clip_skip: tests/test_torch_port_sdxl_models.py)."""
    engine = DiffusionEngine(engines.bundle, "dpm++_2m_cfgpp", nfe=2)

    def first_z0(**extra):
        _, (z0s, _) = engine.sample(PROMPT, cfg_guidance=5.0,
                                    **request("dpm++_2m_cfgpp"), **extra)
        return z0s[0]

    base = first_z0()
    for extra in ({"prompt_2": ["", "an oil painting"]}, MICRO):
        assert float((first_z0(**extra) - base).abs().max()) > 1e-4, extra


def test_main_path_plan_has_24_steps_at_25_nfe(engines):
    """dpm++_2m_cfgpp loops timesteps[:-1]: 24 UNet calls at NFE 25, on
    both sides (the chip run's launch counts rest on it)."""
    assert JaxEngine(engines.jax_bundle, "dpm++_2m_cfgpp",
                     nfe=25).plan.n_steps == 24
    assert DiffusionEngine(engines.bundle, "dpm++_2m_cfgpp",
                           nfe=25).plan.n_steps == 24


def test_sdxl_engine_rejects_lightning_and_sd_solvers(engines):
    """A Lightning solver is refused at w != 1 with the JAX engine's
    message (tests/test_torch_port_lightning.py runs them at w=1); an SD
    solver is no SDXL solver."""
    engine = DiffusionEngine(engines.bundle, "dpm++_2m_cfgpp_lightning")
    with pytest.raises(ValueError, match=r"CFG should be turned off "
                       r"\(cfg_guidance=1\) in the lightning version"):
        engine.sample(PROMPT, cfg_guidance=5.0, **request(engine.solver_name))
    with pytest.raises(ValueError, match="does not exist for family 'sdxl'"):
        DiffusionEngine(engines.bundle, "euler_a_cfg++")
