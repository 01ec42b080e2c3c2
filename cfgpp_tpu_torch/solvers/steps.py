"""Per-step solver math (device side), counterpart of
``cfgpp_tpu/solvers/steps.py``.

CFG uses eps_hat = eps_uc + w (eps_c - eps_uc) for both the Tweedie
estimate and the renoising / ODE derivative; CFG++ renoises (DDIM) or takes
the derivative (k-diffusion) from the unconditional eps
(latent_diffusion.py:666 vs :286, :708, :751, :804, :863-866).  All math
is float32.  ``eps_fn(z, t)`` returns ``(eps_uc, eps_c)`` with z shaped
[B, H, W, C].
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


def ddim_inversion_step(eps_fn: EpsFn, w, c: Dict[str, torch.Tensor],
                        zt: torch.Tensor, *, cfgpp: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward (z0 -> zT) inversion step; returns (zt_next, z0t).

    cfgpp=False -> latent_diffusion.py:172-180 (z0t from eps_hat);
    cfgpp=True  -> :900-908 (z0t from eps_uc, renoise with eps_hat): the
    mirror of CFG++ sampling."""
    eps_uc, eps_c = eps_fn(zt, c["t"])
    eps_hat = cfg_mix(eps_uc, eps_c, w)
    at, at_prev = c["at"], c["at_prev"]
    tweedie_eps = eps_uc if cfgpp else eps_hat
    z0t = (zt - torch.sqrt(1.0 - at_prev) * tweedie_eps) / torch.sqrt(at_prev)
    zt_next = torch.sqrt(at) * z0t + torch.sqrt(1.0 - at) * eps_hat
    return zt_next, z0t


# ---------------------------------------------------------------------------
# k-diffusion family (VE cast)
# ---------------------------------------------------------------------------

def _denoised_pair(eps_fn: EpsFn, w, x: torch.Tensor, c
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kdiffusion_x_to_denoised (latent_diffusion.py:235-241): the guided
    and the unconditional denoised estimates."""
    eps_uc, eps_c = eps_fn(x * c["c_in"], c["t"])
    eps_hat = cfg_mix(eps_uc, eps_c, w)
    denoised = x - eps_hat * c["sigma"]
    uncond_denoised = x - eps_uc * c["sigma"]
    return denoised, uncond_denoised


def euler_step(eps_fn: EpsFn, w, c, x: torch.Tensor, *, cfgpp: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Karras Euler; returns (x_next, denoised).  latent_diffusion.py:324-333
    (CFG), :701-710 (CFG++: the derivative from the uncond estimate)."""
    denoised, uncond = _denoised_pair(eps_fn, w, x, c)
    d_src = uncond if cfgpp else denoised
    d = (x - d_src) / c["sigma"]
    return denoised + d * c["sigma_next"], denoised


def euler_ancestral_step(eps_fn: EpsFn, w, c, x: torch.Tensor,
                         noise: torch.Tensor, *, cfgpp: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Euler ancestral.  latent_diffusion.py:367-379 (CFG), :744-755 (CFG++).
    Noise is added only where sigma_next > 0."""
    denoised, uncond = _denoised_pair(eps_fn, w, x, c)
    d_src = uncond if cfgpp else denoised
    d = (x - d_src) / c["sigma"]
    x_next = denoised + d * c["sigma_down"]
    x_next = torch.where(c["sigma_next"] > 0, x_next + noise * c["sigma_up"],
                         x_next)
    return x_next, denoised


def dpmpp_2s_ancestral_step(eps_fn: EpsFn, w, c, x: torch.Tensor,
                            noise: torch.Tensor, *, cfgpp: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DPM-Solver++(2S) ancestral body (two model calls).
    latent_diffusion.py:410-438 (CFG), :786-814 (CFG++).  Only for steps
    where sigma_down > 0; the last step is `dpmpp_2s_tail_step`."""
    denoised, uncond = _denoised_pair(eps_fn, w, x, c)
    mid_src = uncond if cfgpp else denoised
    x_2 = c["ratio_s"] * x - c["em1_r"] * mid_src

    c_mid = {"c_in": c["c_in_s"], "t": c["t2"], "sigma": c["sigma_s"]}
    denoised_2, uncond_2 = _denoised_pair(eps_fn, w, x_2, c_mid)
    if cfgpp:
        # latent_diffusion.py:811
        x_next = denoised_2 - c["exp_neg_h"] * uncond_2 + c["exp_neg_h"] * x
    else:
        x_next = c["exp_neg_h"] * x - c["em1"] * denoised_2
    return x_next + noise * c["sigma_up"], denoised


def dpmpp_2s_tail_step(eps_fn: EpsFn, w, tail: Dict[str, float],
                       x: torch.Tensor, *, cfgpp: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final 2S step: sigma_down == 0, so x = denoised (+ d * 0).  ``cfgpp``
    is unused: both forms end on the guided estimate."""
    c = {"c_in": tail["c_in"], "sigma": tail["sigma"],
         "t": torch.tensor(tail["t"], dtype=torch.int32, device=x.device)}
    denoised, _ = _denoised_pair(eps_fn, w, x, c)
    return denoised, denoised


def dpmpp_2m_step(eps_fn: EpsFn, w, c, carry, *, cfgpp: bool,
                  diff_cfgpp_uses_uncond: bool = False):
    """DPM-Solver++(2M) multistep; returns ((x_next, old_next), denoised).

    carry = (x, old_denoised), old_denoised zeros at the first step.
    CFG: latent_diffusion.py:472-490.  CFG++ (SD): :848-866, the exp term
    from the UNCOND denoised, the difference term (denoised - old) with old
    the previous UNCOND.  ``diff_cfgpp_uses_uncond``: SDXL's
    ``dpm++_2m_cfgpp`` (latent_sdxl.py:916) takes (uncond - old) instead."""
    x, old_denoised = carry
    denoised, uncond = _denoised_pair(eps_fn, w, x, c)

    d_src = uncond if cfgpp else denoised
    euler_x = denoised + (x - d_src) / c["sigma"] * c["sigma_next"]

    exp_term = uncond if cfgpp else denoised
    diff_cur = uncond if (cfgpp and diff_cfgpp_uses_uncond) else denoised
    extra1 = (-c["exp_neg_h"] * exp_term
              - c["em1_over_2r"] * (diff_cur - old_denoised))
    x_2m = denoised + extra1 + c["exp_neg_h"] * x

    x_next = torch.where(c["use_2m"] > 0, x_2m, euler_x)
    new_old = uncond if cfgpp else denoised
    return (x_next, new_old), denoised


# ---------------------------------------------------------------------------
# flow matching (SD3): ``eps_fn`` returns the velocities (v_uc, v_c)
# ---------------------------------------------------------------------------

def flow_euler_step(v_fn: EpsFn, w, c, x: torch.Tensor, *, cfgpp: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Euler step of the flow ODE; returns (x_next, x0).  x0 = x -
    sigma v_w with v_w = v_uc + w (v_c - v_uc).  CFG (diffusers' SD3):
    x_next = x + (sigma_next - sigma) v_w.  CFG++: x_next rebuilt from x0
    and the unconditional noise estimate eps_uc = x + (1 - sigma) v_uc,
    x_next = (1 - sigma_next) x0 + sigma_next eps_uc, which is the Euler
    step where v_c = v_uc."""
    v_uc, v_c = v_fn(x, c["t"])
    v = cfg_mix(v_uc, v_c, w)
    sigma, sigma_next = c["sigma"], c["sigma_next"]
    x0 = x - sigma * v
    if cfgpp:
        eps_uc = x + (1.0 - sigma) * v_uc
        return (1.0 - sigma_next) * x0 + sigma_next * eps_uc, x0
    return x + (sigma_next - sigma) * v, x0
