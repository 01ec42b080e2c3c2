"""Paired image metrics: PSNR / MSE (parity: utils/calculate_metrics.py,
with the reference's broken MSE/MNC classes fixed rather than propagated —
SURVEY.md 'quirks', calculate_metrics.py:134,190-195).

A copy of ``cfgpp_tpu/metrics/functional.py`` (numpy only), so that the
port imports nothing of the JAX package; ``tests/test_torch_port_copies.py``
holds the two equal."""

from __future__ import annotations

import numpy as np


def mse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2))


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Peak SNR; reference uses skimage's psnr with data_range 255
    (calculate_metrics.py:154-164)."""
    err = mse(a, b)
    if err == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / err))


def mnc(a: np.ndarray, b: np.ndarray) -> float:
    """Maximum normalized cross-correlation between two images."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))
