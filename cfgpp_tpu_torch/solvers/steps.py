"""Per-step solver math (device side), counterpart of
``cfgpp_tpu/solvers/steps.py``.

CFG uses eps_hat = eps_uc + w (eps_c - eps_uc) for both the Tweedie
estimate and the renoising; CFG++ renoises with the unconditional eps
(latent_diffusion.py:666 vs :286).  All math is float32.  ``eps_fn(z, t)``
returns ``(eps_uc, eps_c)`` with z shaped [B, H, W, C].
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

EpsFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def cfg_mix(eps_uc: torch.Tensor, eps_c: torch.Tensor, w) -> torch.Tensor:
    """Classifier-free guidance mix (latent_diffusion.py:280)."""
    return eps_uc + w * (eps_c - eps_uc)


def ddim_step(eps_fn: EpsFn, w, c: Dict[str, torch.Tensor], zt: torch.Tensor,
              *, cfgpp: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One DDIM step; returns (zt_next, z0t).  cfgpp=False ->
    latent_diffusion.py:274-286; cfgpp=True -> :654-666."""
    eps_uc, eps_c = eps_fn(zt, c["t"])
    eps_hat = cfg_mix(eps_uc, eps_c, w)
    at, at_prev = c["at"], c["at_prev"]
    z0t = (zt - torch.sqrt(1.0 - at) * eps_hat) / torch.sqrt(at)
    renoise = eps_uc if cfgpp else eps_hat
    zt_next = torch.sqrt(at_prev) * z0t + torch.sqrt(1.0 - at_prev) * renoise
    return zt_next, z0t
