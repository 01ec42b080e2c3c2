"""Karras / k-diffusion (VE-cast) schedule utilities.

A copy of ``cfgpp_tpu/schedules/karras.py``, so that the port imports
nothing of the JAX package; ``tests/test_torch_port_copies.py`` holds the
two equal.

Host-side float64 numpy equivalents of the k-diffusion helpers the reference
uses (`latent_diffusion.py:30-50,211-241` and `latent_sdxl.py:326-363`).
All of these feed precomputed per-step coefficient arrays into the
solvers' loops; none of this runs on the device.
"""

from __future__ import annotations

import numpy as np


def append_zero(x: np.ndarray) -> np.ndarray:
    """`latent_diffusion.py:40-41`."""
    return np.concatenate([x, np.zeros((1,), dtype=x.dtype)])


def get_sigmas_karras(n: int, sigma_min: float, sigma_max: float, rho: float = 7.0) -> np.ndarray:
    """Karras et al. (2022) sigma ramp with a trailing 0. Shape [n+1].

    Matches `latent_diffusion.py:44-50`: ramp = linspace(0,1,n+1)[:-1].
    """
    ramp = np.linspace(0.0, 1.0, n + 1, dtype=np.float64)[:-1]
    min_inv_rho = sigma_min ** (1.0 / rho)
    max_inv_rho = sigma_max ** (1.0 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return append_zero(sigmas)


def get_ancestral_step(sigma_from: float, sigma_to: float, eta: float = 1.0):
    """(sigma_down, sigma_up) for an ancestral step. `latent_diffusion.py:30-37`."""
    if not eta:
        return sigma_to, 0.0
    sigma_up = min(
        sigma_to,
        eta * (sigma_to**2 * (sigma_from**2 - sigma_to**2) / sigma_from**2) ** 0.5,
    )
    sigma_down = (sigma_to**2 - sigma_up**2) ** 0.5
    return sigma_down, sigma_up


def timestep_log_nearest(sigma, log_sigmas: np.ndarray):
    """sigma -> model timestep: nearest neighbour in log-sigma space.

    Matches `StableDiffusion.timestep` (`latent_diffusion.py:211-214`).
    ``log_sigmas`` is log of the [T] VE sigma table; returns int64.
    """
    sigma = np.asarray(sigma, dtype=np.float64)
    dists = np.abs(np.log(sigma)[..., None] - log_sigmas[None, :])
    return np.argmin(dists, axis=-1).astype(np.int64)


def sigma_to_t_linear(sigma, total_sigmas: np.ndarray, quantize: bool):
    """sigma -> t via LINEAR-sigma distance (k_diffusion/external.py style).

    Matches `SDXL.sigma_to_t` (`latent_sdxl.py:333-346`): quantized form takes
    the argmin of |sigma - sigmas|; unquantized interpolates a fractional t.
    """
    sigma = np.asarray(sigma, dtype=np.float64)
    dists = sigma[None, ...] - total_sigmas[:, None]
    if quantize:
        return np.abs(dists).argmin(axis=0).reshape(np.shape(sigma)).astype(np.int64)
    low_idx = np.clip(
        np.argmax(np.cumsum(dists >= 0, axis=0), axis=0), None, total_sigmas.shape[0] - 2
    )
    high_idx = low_idx + 1
    low, high = total_sigmas[low_idx], total_sigmas[high_idx]
    w = np.clip((low - sigma) / (low - high), 0.0, 1.0)
    return ((1 - w) * low_idx + w * high_idx).reshape(np.shape(sigma))


def calculate_input_scale(sigma):
    """c_in for the VE cast: x_model = x / sqrt(sigma^2+1). `latent_diffusion.py:229-230`."""
    return 1.0 / np.sqrt(np.asarray(sigma, dtype=np.float64) ** 2 + 1.0)
