"""Per-solver coefficient planning (host, numpy), counterpart of
``cfgpp_tpu/solvers/plans.py``.

Ported rather than imported: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from cfgpp_tpu_torch.schedules.ddim import DDIMSchedule


@dataclasses.dataclass(frozen=True)
class SolverPlan:
    """Stacked per-step coefficients for a sampling loop.

    ``coeffs`` maps name -> float32/int32 array of leading dim ``n_steps``;
    zT is a standard normal draw times ``init_scale``; ``final`` names what
    the loop returns ("z0": the last Tweedie estimate)."""

    n_steps: int
    coeffs: Dict[str, np.ndarray]
    init: str
    init_scale: float
    needs_noise: bool
    final: str


def _f32(**kw) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in kw.items():
        arr = np.asarray(v)
        out[k] = (arr.astype(np.int32) if np.issubdtype(arr.dtype, np.integer)
                  else arr.astype(np.float32))
    return out


def plan_ddim(schedule: DDIMSchedule) -> SolverPlan:
    """DDIM (VP space).  Reference: latent_diffusion.py:247-299, 621-679."""
    ts = schedule.timesteps
    at = np.array([schedule.alpha(int(t)) for t in ts])
    at_prev = np.array([schedule.alpha(int(t) - schedule.skip) for t in ts])
    return SolverPlan(
        n_steps=len(ts),
        coeffs=_f32(t=ts, at=at, at_prev=at_prev),
        init="vp_normal",
        init_scale=1.0,
        needs_noise=False,
        final="z0",
    )
