"""Generic sampling loop, counterpart of ``cfgpp_tpu/solvers/sampler.py``.

PyTorch runs eagerly, so the JAX package's ``lax.scan`` over the plan rows
becomes a Python loop over the same rows.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from cfgpp_tpu_torch.solvers import steps
from cfgpp_tpu_torch.solvers.plans import SolverPlan
from cfgpp_tpu_torch.solvers.registry import SolverSpec

Trajectory = Tuple[torch.Tensor, torch.Tensor]


def init_latent(plan: SolverPlan, generator: torch.Generator,
                shape: Sequence[int], dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
    """Draw zT on the generator's device (latent_diffusion.py:198-200)."""
    return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                       device=generator.device) * plan.init_scale


def run_solver(spec: SolverSpec, plan: SolverPlan, eps_fn,
               zT: torch.Tensor, cfg_guidance: float,
               return_trajectory: bool = False
               ) -> Tuple[torch.Tensor, Optional[Trajectory]]:
    """Run the reverse process.  Returns (final latent, trajectory), where
    the trajectory is the stacked per-step (z0t, zt) when asked for."""
    if spec.kind != "ddim":
        raise ValueError(f"unknown solver kind {spec.kind}")
    coeffs = {k: torch.as_tensor(v, device=zT.device)
              for k, v in plan.coeffs.items()}
    w = torch.tensor(cfg_guidance, dtype=torch.float32, device=zT.device)
    zt, z0s, zts = zT, [], []
    for i in range(plan.n_steps):
        zt, z0t = steps.ddim_step(eps_fn, w, {k: v[i] for k, v in coeffs.items()},
                                  zt, cfgpp=spec.cfgpp)
        if return_trajectory:
            z0s.append(z0t)
            zts.append(zt)
    final = z0t if plan.final == "z0" else zt
    if return_trajectory:
        return final, (torch.stack(z0s), torch.stack(zts))
    return final, None
