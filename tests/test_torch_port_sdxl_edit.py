"""SDXL's edit solvers, ``ddim_cfg++``, ``clip_skip`` and the
unconditional branch alone through the port's DiffusionEngine against
cfgpp_tpu's, on ``tiny_sdxl``: ``ddim_edit`` (w=7.5) and
``ddim_edit_cfg++`` (lambda=0.6) with three prompts (inversion with the
source prompt and its pooled embeds, resampling with the target's; the
CFG++ one with three encoder-2 prompts too), and ``ddim_cfg++`` at w=0
(the unconditional branch alone, with its added conditioning) with
``clip_skip=1`` (one JAX compile for both: ``clip_skip`` is part of the
JAX engine's cache key).  Plain ``ddim`` runs in
tests/test_torch_port_sdxl_engine.py (the conditional branch alone); the
pair with CFG's mix runs in ``euler`` and ``ddim_edit``, with CFG++'s in
``dpm++_2m_cfgpp``, ``euler_cfg++`` and ``ddim_edit_cfg++``.  Requests,
weights, the shared JAX engines and the tolerance (1e-4 x max(1, scale)
per step and image) as in tests/test_torch_port_sdxl_engine.py.
"""

import pytest
import torch

from cfgpp_tpu_torch.engine import DiffusionEngine
from tests.test_torch_port_sdxl_engine import (EDIT_PROMPT, PROMPT, hold,
                                               run_both)
from tests.test_torch_port_sdxl_engine import engines  # noqa: F401


@pytest.mark.parametrize("solver,w,extra", [
    ("ddim_edit", 7.5, {}),
    ("ddim_edit_cfg++", 0.6, {"prompt_2": ["", "an oil painting of a cat",
                                           "an oil painting of a dog"]}),
    # the unconditional branch alone, its context from both encoders'
    # clip_skip=1 tap
    ("ddim_cfg++", 0.0, {"clip_skip": 1}),
], ids=["ddim_edit", "ddim_edit_cfg++", "w0_clip_skip"])
def test_matches_jax(engines, solver, w, extra):
    prompt = EDIT_PROMPT if "edit" in solver else PROMPT
    got, want = run_both(engines, solver, w, prompt, **extra)
    hold(got, want, f"{solver} w={w} {sorted(extra)}")


def test_sd_family_refuses_clip_skip():
    from cfgpp_tpu_torch.engine import ModelBundle

    tb = ModelBundle.random_init("tiny_sd", seed=0, dtype=torch.float32,
                                 device="cpu")
    with pytest.raises(ValueError, match="clip_skip is an SDXL-only option"):
        DiffusionEngine(tb, "ddim", nfe=2).sample(PROMPT, clip_skip=1,
                                                  resolution=16)
