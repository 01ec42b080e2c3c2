"""The reference's noise schedule, solver plans and sampling loops, written
from the sources the program follows (diffusers 0.27 `DDIMScheduler`, the
CFG++ paper's DDIM form, and the SDXL `dpm++_2m_cfgpp` of the CFG++
reference code, ``latent_sdxl.py:860-930``).  float64 tables on the host,
float32 on the device.

``eps_fn(z, t) -> (eps_uncond, eps_cond)``.  Supported: ``ddim_cfg++``,
``ddim_cfg++_lightning`` (trailing timesteps) and ``dpm++_2m_cfgpp`` (SDXL).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

T_TRAIN, BETA_START, BETA_END = 1000, 0.00085, 0.012

SOLVERS = {
    # name: (kind, timestep spacing)
    "ddim_cfg++": ("ddim", "leading"),
    "ddim_cfg++_lightning": ("ddim", "trailing"),
    "dpm++_2m_cfgpp": ("dpm2m", "leading"),
}


def alphas_cumprod() -> np.ndarray:
    betas = np.linspace(BETA_START ** 0.5, BETA_END ** 0.5, T_TRAIN,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def timesteps(nfe: int, spacing: str) -> np.ndarray:
    if spacing == "leading":       # steps_offset 1
        return (np.arange(nfe) * (T_TRAIN // nfe)).round()[::-1].astype(
            np.int64) + 1
    return np.arange(T_TRAIN, 0, -T_TRAIN / nfe).round().astype(np.int64) - 1


def plan(solver: str, nfe: int) -> Tuple[str, Dict[str, np.ndarray], float]:
    """(kind, per-step coefficients, the scale of the initial normal draw).

    The alpha table is the reference code's, with 1.0 prepended and indexed
    by the raw timestep, and alpha(t < 0) = alphas_cumprod[0]."""
    kind, spacing = SOLVERS[solver]
    abar = alphas_cumprod()
    ext = np.concatenate([[1.0], abar])
    ts = timesteps(nfe, spacing)

    def alpha(t):
        return ext[t] if t >= 0 else abar[0]

    if kind == "ddim":
        skip = T_TRAIN // nfe
        return kind, {"t": ts.astype(np.float64),
                      "at": np.array([alpha(t) for t in ts]),
                      "at_prev": np.array([alpha(t - skip) for t in ts])}, 1.0
    # dpm++ 2M on the VP sigmas of the timesteps, over timesteps[:-1]
    alphas = ext[ts]
    sig = np.sqrt((1.0 - alphas) / alphas)
    total = np.sqrt((1.0 - abar) / abar)
    n = len(ts) - 1
    t_model = np.abs(sig[:n][None] - total[:, None]).argmin(axis=0)
    h = np.log(sig[:n]) - np.log(sig[1:n + 1])
    h_last = np.concatenate([[1.0], -np.log(sig[1:n]) + np.log(sig[:n - 1])])
    use_2m = np.arange(n) > 0
    r = h_last / h
    return kind, {"t": t_model.astype(np.float64), "sigma": sig[:n],
                  "sigma_next": sig[1:n + 1], "c_in": np.sqrt(alphas[:n]),
                  "exp_neg_h": np.where(use_2m, np.exp(-h), 0.0),
                  "em1_over_2r": np.where(use_2m, np.expm1(-h) / (2 * r), 0.0),
                  "use_2m": use_2m.astype(np.float64)}, float(sig[0])


def sample(solver: str, nfe: int, eps_fn, zT: torch.Tensor,
           w: float) -> torch.Tensor:
    """The final latent of one CFG++ sampling loop from zT."""
    kind, co, _ = plan(solver, nfe)
    n = len(co["t"])
    c = [{k: float(v[i]) for k, v in co.items()} for i in range(n)]
    if kind == "ddim":
        z, z0 = zT, zT
        for s in c:
            e_u, e_c = eps_fn(z, s["t"])
            e = e_u + w * (e_c - e_u)
            z0 = (z - (1 - s["at"]) ** 0.5 * e) / s["at"] ** 0.5
            z = s["at_prev"] ** 0.5 * z0 + (1 - s["at_prev"]) ** 0.5 * e_u
        return z0
    x, old = zT, torch.zeros_like(zT)
    for s in c:
        e_u, e_c = eps_fn(x * s["c_in"], s["t"])
        den = x - (e_u + w * (e_c - e_u)) * s["sigma"]
        unc = x - e_u * s["sigma"]
        if s["use_2m"] > 0:
            x = den - s["exp_neg_h"] * unc \
                - s["em1_over_2r"] * (unc - old) + s["exp_neg_h"] * x
        else:
            x = den + (x - unc) / s["sigma"] * s["sigma_next"]
        old = unc
    return x
