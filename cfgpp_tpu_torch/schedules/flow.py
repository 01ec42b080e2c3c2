"""The flow-matching schedule of SD3 (diffusers'
`FlowMatchEulerDiscreteScheduler` with ``shift``, as SD3's pipeline sets
its timesteps).

With s(u) = shift u / (1 + (shift - 1) u) and N training steps: sigma_min
= s(1 / N); the n timesteps are ``linspace(N, N sigma_min, n)``; step i's
noise level is sigma_i = s(t_i / N) (so the shift applies twice at the low
end, as diffusers' does), and sigma_n = 0.  The model is fed N sigma_i.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FlowSchedule:
    sigmas: np.ndarray        # [n + 1] float64, from about 1 down to 0
    timesteps: np.ndarray     # [n] float64, N sigma_i

    @property
    def n_steps(self) -> int:
        return len(self.timesteps)


def shifted(u, shift: float):
    return shift * u / (1.0 + (shift - 1.0) * u)


def make_flow_schedule(nfe: int, shift: float = 3.0,
                       num_train_timesteps: int = 1000) -> FlowSchedule:
    n = float(num_train_timesteps)
    sigma_min = shifted(1.0 / n, shift)
    t = np.linspace(n, n * sigma_min, nfe)
    sigmas = shifted(t / n, shift)
    return FlowSchedule(sigmas=np.append(sigmas, 0.0), timesteps=sigmas * n)
