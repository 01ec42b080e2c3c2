"""DDIM / VP noise-schedule tables.

A copy of ``cfgpp_tpu/schedules/ddim.py``, so that the port imports nothing
of the JAX package; ``tests/test_torch_port_copies.py`` holds the two equal.

Pure host-side (numpy, float64) precomputation of every scalar table the
solvers need.  Semantics match diffusers 0.27.1 as used by the reference
(the reference's `latent_diffusion.py:69-90`, `latent_sdxl.py:56-74`):

* ``scaled_linear`` beta schedule (``linspace(sqrt(b0), sqrt(b1), T)**2``),
* ``DDIMScheduler.set_timesteps`` with ``timestep_spacing="leading"`` and
  ``steps_offset=1``,
* ``EulerDiscreteScheduler.set_timesteps`` with
  ``timestep_spacing="trailing"`` (SDXL-Lightning),
* the reference's own prepended-1.0 alpha table: it runs
  ``alphas_cumprod = cat([1.0], alphas_cumprod)`` and then indexes with raw
  timesteps, so ``alpha(t) == alpha_bar_orig[t-1]``
  (`latent_diffusion.py:80,88-90`).  We replicate that table exactly because
  it defines the reference trajectories.

Known reference quirk we do NOT replicate (documented divergence): the SDXL
DDIM solvers index ``alphas_cumprod[next_t]`` with a possibly negative
``next_t`` (`latent_sdxl.py:444-446`), which in PyTorch wraps around to the
END of the table.  That wrapped value only ever affects the *discarded* final
``zt`` (the solvers return ``z0t``), so we use the guarded
``final_alpha_cumprod`` lookup everywhere (`latent_diffusion.py:88-90`).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

# SD / SDXL train-time schedule constants (diffusers scheduler_config.json).
DEFAULT_BETA_START = 0.00085
DEFAULT_BETA_END = 0.012
DEFAULT_NUM_TRAIN_TIMESTEPS = 1000
DEFAULT_STEPS_OFFSET = 1


def scaled_linear_betas(
    num_train_timesteps: int = DEFAULT_NUM_TRAIN_TIMESTEPS,
    beta_start: float = DEFAULT_BETA_START,
    beta_end: float = DEFAULT_BETA_END,
) -> np.ndarray:
    """``scaled_linear`` beta ramp: linear in sqrt-beta space."""
    return (
        np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64)
        ** 2
    )


def alphas_cumprod_table(
    num_train_timesteps: int = DEFAULT_NUM_TRAIN_TIMESTEPS,
    beta_start: float = DEFAULT_BETA_START,
    beta_end: float = DEFAULT_BETA_END,
) -> np.ndarray:
    """alpha-bar table: cumprod(1 - beta).  Shape [T], float64."""
    return np.cumprod(1.0 - scaled_linear_betas(num_train_timesteps, beta_start, beta_end))


def leading_timesteps(num_inference_steps: int, num_train_timesteps: int = DEFAULT_NUM_TRAIN_TIMESTEPS, steps_offset: int = DEFAULT_STEPS_OFFSET) -> np.ndarray:
    """DDIM 'leading' spacing, descending ints.

    ``(arange(n) * (T // n)).round()[::-1] + steps_offset``; e.g. 50 NFE with
    T=1000 gives [981, 961, ..., 1].
    """
    step_ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
    return ts + steps_offset


def trailing_timesteps(num_inference_steps: int, num_train_timesteps: int = DEFAULT_NUM_TRAIN_TIMESTEPS) -> np.ndarray:
    """Euler 'trailing' spacing (SDXL-Lightning), descending ints.

    ``round(arange(T, 0, -T/n)) - 1``; e.g. 4 NFE gives [999, 749, 499, 249].
    """
    step_ratio = num_train_timesteps / num_inference_steps
    ts = np.arange(num_train_timesteps, 0, -step_ratio).round().astype(np.int64) - 1
    return ts


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Everything a VP-space (DDIM-family) solver needs, precomputed.

    ``alphas_ext`` is the reference's shifted table: ``[1.0, abar_0 ... abar_{T-1}]``
    so that ``alpha(t) = alphas_ext[t]`` reproduces `latent_diffusion.py:80,88-90`.
    """

    num_train_timesteps: int
    num_inference_steps: int
    timesteps: np.ndarray          # [n] descending ints (model-facing t values)
    skip: int                      # T // n  (reference `self.skip`)
    alphas_cumprod: np.ndarray     # [T] original alpha-bar, float64
    alphas_ext: np.ndarray         # [T+1] prepended-1.0 table, float64
    final_alpha_cumprod: float     # used when t-skip < 0

    def alpha(self, t: int) -> float:
        """Guarded lookup matching `latent_diffusion.py:88-90`."""
        return float(self.alphas_ext[t]) if t >= 0 else self.final_alpha_cumprod

    @property
    def sigmas_ve(self) -> np.ndarray:
        """Full-resolution VE sigmas over the ORIGINAL table: sqrt((1-a)/a). [T]."""
        a = self.alphas_cumprod
        return np.sqrt((1.0 - a) / a)


def make_ddim_schedule(
    num_inference_steps: int,
    num_train_timesteps: int = DEFAULT_NUM_TRAIN_TIMESTEPS,
    beta_start: float = DEFAULT_BETA_START,
    beta_end: float = DEFAULT_BETA_END,
    steps_offset: int = DEFAULT_STEPS_OFFSET,
    set_alpha_to_one: bool = False,
    timestep_spacing: str = "leading",
) -> DDIMSchedule:
    """Build the schedule the reference builds in `StableDiffusion.__init__`.

    ``set_alpha_to_one=False`` is the SD-v1.5 scheduler config, giving
    ``final_alpha_cumprod = alphas_cumprod[0]``.
    """
    abar = alphas_cumprod_table(num_train_timesteps, beta_start, beta_end)
    if timestep_spacing == "leading":
        ts = leading_timesteps(num_inference_steps, num_train_timesteps, steps_offset)
    elif timestep_spacing == "trailing":
        ts = trailing_timesteps(num_inference_steps, num_train_timesteps)
    else:
        raise ValueError(f"unknown timestep_spacing: {timestep_spacing}")
    return DDIMSchedule(
        num_train_timesteps=num_train_timesteps,
        num_inference_steps=num_inference_steps,
        timesteps=ts,
        skip=num_train_timesteps // num_inference_steps,
        alphas_cumprod=abar,
        alphas_ext=np.concatenate([[1.0], abar]),
        final_alpha_cumprod=1.0 if set_alpha_to_one else float(abar[0]),
    )


@lru_cache(maxsize=8)
def cached_ddim_schedule(num_inference_steps: int, **kwargs) -> DDIMSchedule:
    return make_ddim_schedule(num_inference_steps, **kwargs)
