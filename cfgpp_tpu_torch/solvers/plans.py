"""Per-solver coefficient planning (host, numpy), counterpart of
``cfgpp_tpu/solvers/plans.py``.

Ported rather than imported: the port imports nothing of the JAX package.
A plan is precomputed on the host in float64 and stacked into per-step
float32/int32 arrays; the sampler's loop reads one row per step.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Optional

import numpy as np

from cfgpp_tpu_torch.schedules.ddim import DDIMSchedule
from cfgpp_tpu_torch.schedules.karras import (
    calculate_input_scale,
    get_ancestral_step,
    get_sigmas_karras,
    sigma_to_t_linear,
    timestep_log_nearest,
)

if TYPE_CHECKING:          # SD3's schedule; not loaded on the SD / SDXL path
    from cfgpp_tpu_torch.schedules.flow import FlowSchedule


@dataclasses.dataclass(frozen=True)
class SolverPlan:
    """Stacked per-step coefficients for a sampling loop.

    ``coeffs`` maps name -> float32/int32 array of leading dim ``n_steps``;
    zT is a standard normal draw times ``init_scale``; ``final`` names what
    the loop returns ("z0": the last Tweedie estimate, "x": the running
    latent).  ``tail_coeffs``: the eulerized last step run after the loop
    (DPM++ 2S)."""

    n_steps: int
    coeffs: Dict[str, np.ndarray]
    init: str                    # "vp_normal" | "ve_scaled" | "flow_normal"
    init_scale: float            # 1.0 for VP; sqrt(sig0^2+1) for VE
    needs_noise: bool            # ancestral solvers draw per-step gaussians
    final: str                   # "z0" | "x"
    tail_coeffs: Optional[Dict[str, float]] = None


def _f32(**kw) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in kw.items():
        arr = np.asarray(v)
        out[k] = (arr.astype(np.int32) if np.issubdtype(arr.dtype, np.integer)
                  else arr.astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# DDIM family (VP space).  Reference: latent_diffusion.py:247-299, 621-679.
# ---------------------------------------------------------------------------

def plan_ddim(schedule: DDIMSchedule) -> SolverPlan:
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


def plan_ddim_inversion(schedule: DDIMSchedule) -> SolverPlan:
    """Forward (z0 -> zT) loop over reversed timesteps.
    latent_diffusion.py:160-182."""
    ts = schedule.timesteps[::-1].copy()
    at = np.array([schedule.alpha(int(t)) for t in ts])
    at_prev = np.array([schedule.alpha(int(t) - schedule.skip) for t in ts])
    return SolverPlan(
        n_steps=len(ts),
        coeffs=_f32(t=ts, at=at, at_prev=at_prev),
        init="vp_normal",      # unused: inversion starts from an encoded image
        init_scale=1.0,
        needs_noise=False,
        final="x",
    )


# ---------------------------------------------------------------------------
# k-diffusion family (VE cast).  Reference: latent_diffusion.py:302-503.
# ---------------------------------------------------------------------------

def _karras_base(schedule: DDIMSchedule):
    """(log of the [T] VE sigma table, the [n+1] Karras sigmas)."""
    total_sigmas = schedule.sigmas_ve
    sigmas = get_sigmas_karras(schedule.num_inference_steps,
                               float(total_sigmas.min()),
                               float(total_sigmas.max()))
    return np.log(total_sigmas), sigmas


def plan_euler(schedule: DDIMSchedule) -> SolverPlan:
    log_sigmas, sigmas = _karras_base(schedule)
    n = schedule.num_inference_steps
    sig, sig_next = sigmas[:n], sigmas[1:n + 1]
    return SolverPlan(
        n_steps=n,
        coeffs=_f32(
            t=timestep_log_nearest(sig, log_sigmas),
            sigma=sig,
            sigma_next=sig_next,
            c_in=calculate_input_scale(sig),
        ),
        init="ve_scaled",
        init_scale=float(np.sqrt(sigmas[0] ** 2 + 1.0)),  # latent_diffusion.py:201-205
        needs_noise=False,
        final="z0",   # the reference decodes `denoised` (latent_diffusion.py:344)
    )


def _ancestral_split(sig, sig_next):
    downs, ups = zip(*(get_ancestral_step(float(a), float(b))
                       for a, b in zip(sig, sig_next)))
    return np.array(downs), np.array(ups)


def plan_euler_ancestral(schedule: DDIMSchedule) -> SolverPlan:
    log_sigmas, sigmas = _karras_base(schedule)
    n = schedule.num_inference_steps
    sig, sig_next = sigmas[:n], sigmas[1:n + 1]
    downs, ups = _ancestral_split(sig, sig_next)
    return SolverPlan(
        n_steps=n,
        coeffs=_f32(
            t=timestep_log_nearest(sig, log_sigmas),
            sigma=sig,
            sigma_next=sig_next,
            sigma_down=downs,
            sigma_up=ups,
            c_in=calculate_input_scale(sig),
        ),
        init="ve_scaled",
        init_scale=float(np.sqrt(sigmas[0] ** 2 + 1.0)),
        needs_noise=True,
        final="z0",
    )


def plan_dpmpp_2s_ancestral(schedule: DDIMSchedule) -> SolverPlan:
    """DPM-Solver++(2S) ancestral.  latent_diffusion.py:393-451, 769-827.

    The loop covers steps 0..n-2 (the full 2S body, two model calls); the
    last step has sigma_down == 0 and collapses to ``x = denoised``, run
    after the loop from ``tail_coeffs``."""
    log_sigmas, sigmas = _karras_base(schedule)
    n = schedule.num_inference_steps
    sig, sig_next = sigmas[:n], sigmas[1:n + 1]
    downs, ups = _ancestral_split(sig, sig_next)

    body = slice(0, n - 1)
    t_log = -np.log(sig[body])
    t_next = -np.log(downs[body])
    h = t_next - t_log
    s = t_log + 0.5 * h
    sigma_s = np.exp(-s)
    return SolverPlan(
        n_steps=n - 1,
        coeffs=_f32(
            t=timestep_log_nearest(sig[body], log_sigmas),
            t2=timestep_log_nearest(sigma_s, log_sigmas),
            sigma=sig[body],
            sigma_s=sigma_s,
            c_in=calculate_input_scale(sig[body]),
            c_in_s=calculate_input_scale(sigma_s),
            ratio_s=sigma_s / sig[body],                  # sigma_fn(s)/sigma_fn(t)
            em1_r=np.expm1(-h * 0.5),
            exp_neg_h=np.exp(-h),
            em1=np.expm1(-h),
            sigma_up=ups[body],
        ),
        init="ve_scaled",
        init_scale=float(np.sqrt(sigmas[0] ** 2 + 1.0)),
        needs_noise=True,
        final="x",
        tail_coeffs={
            "t": int(np.ravel(timestep_log_nearest(sig[-1], log_sigmas))[0]),
            "sigma": float(sig[-1]),
            "c_in": float(np.ravel(calculate_input_scale(sig[-1]))[0]),
        },
    )


def plan_dpmpp_2m(schedule: DDIMSchedule) -> SolverPlan:
    """DPM-Solver++(2M) multistep on Karras sigmas.
    latent_diffusion.py:454-503, 830-879."""
    log_sigmas, sigmas = _karras_base(schedule)
    n = schedule.num_inference_steps
    return _plan_2m_from_sigmas(sigmas, n,
                                timestep_log_nearest(sigmas[:n], log_sigmas),
                                calculate_input_scale(sigmas[:n]),
                                init_scale=float(np.sqrt(sigmas[0] ** 2 + 1.0)))


def _plan_2m_from_sigmas(sigmas, n, t_model, c_in, init_scale) -> SolverPlan:
    sig, sig_next = sigmas[:n], sigmas[1:n + 1]
    with np.errstate(divide="ignore"):
        t_log = -np.log(sig)
        t_log_next = -np.log(np.where(sig_next > 0, sig_next, 1.0))
    h = t_log_next - t_log
    # r = h_last / h; the first step has no h_last and takes the euler branch.
    h_last = np.concatenate([[1.0], t_log[1:] - t_log[:-1]])
    r = h_last / np.where(h != 0, h, 1.0)
    use_2m = (np.arange(n) > 0) & (sig_next > 0)
    return SolverPlan(
        n_steps=n,
        coeffs=_f32(
            t=t_model,
            sigma=sig,
            sigma_next=sig_next,
            c_in=c_in,
            exp_neg_h=np.where(use_2m, np.exp(-h), 0.0),
            em1_over_2r=np.where(use_2m, np.expm1(-h) / (2.0 * r), 0.0),
            use_2m=use_2m.astype(np.float32),
        ),
        init="ve_scaled",
        init_scale=init_scale,
        needs_noise=False,
        final="x",
    )


# ---------------------------------------------------------------------------
# SDXL's VP-native sigma plans.  Reference: latent_sdxl.py:776-777, 860-930.
# ---------------------------------------------------------------------------

def plan_dpmpp_2m_vp_sdxl(schedule: DDIMSchedule) -> SolverPlan:
    """SDXL `dpm++_2m_cfgpp`: VP-native sigmas from the DDIM timesteps.

    latent_sdxl.py:860-930 — sigmas come from the (prepended) alpha table at
    the scheduler timesteps, NO appended zero, and the loop runs
    `timesteps[:-1]` (n-1 steps).  x initialises to randn * sigmas[0], and
    the model t is the LINEAR-sigma quantized lookup (sigma_to_t).
    """
    ts = schedule.timesteps
    alphas = schedule.alphas_ext[ts]                      # latent_sdxl.py:878
    sigmas = np.sqrt((1.0 - alphas) / alphas)
    total_sigmas = schedule.sigmas_ve
    n = len(ts) - 1                                       # loops timesteps[:-1]
    t_model = sigma_to_t_linear(sigmas[:n], total_sigmas, quantize=True)
    c_in = np.sqrt(alphas[:n])                            # latent_sdxl.py:895
    return _plan_2m_from_sigmas(sigmas, n, t_model, c_in,
                                init_scale=float(sigmas[0]))


def plan_euler_vp_sigmas_sdxl(schedule: DDIMSchedule) -> SolverPlan:
    """SDXL `euler_cfg++`: sigmas from actual DDIM timesteps (latent_sdxl.py:776-777)."""
    total_sigmas = schedule.sigmas_ve
    log_sigmas = np.log(total_sigmas)
    ts = schedule.timesteps
    sigmas = np.concatenate([total_sigmas[ts], [0.0]])
    n = len(ts)
    sig, sig_next = sigmas[:n], sigmas[1 : n + 1]
    return SolverPlan(
        n_steps=n,
        coeffs=_f32(
            t=timestep_log_nearest(sig, log_sigmas),
            sigma=sig,
            sigma_next=sig_next,
            c_in=calculate_input_scale(sig),
        ),
        init="ve_scaled",
        init_scale=float(np.sqrt(sigmas[0] ** 2 + 1.0)),
        needs_noise=False,
        final="z0",
    )


# ---------------------------------------------------------------------------
# Flow matching (SD3): the latent moves from noise (sigma 1) to data
# (sigma 0) along the model's velocity; zT is a standard normal draw.
# ---------------------------------------------------------------------------

def plan_flow_euler(schedule: FlowSchedule) -> SolverPlan:
    sig = schedule.sigmas
    return SolverPlan(
        n_steps=schedule.n_steps,
        coeffs=_f32(t=schedule.timesteps, sigma=sig[:-1], sigma_next=sig[1:]),
        init="flow_normal",
        init_scale=1.0,
        needs_noise=False,
        final="x",
    )
