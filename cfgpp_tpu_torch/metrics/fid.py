"""Frechet distance machinery for FID-style metrics.

A copy of ``cfgpp_tpu/metrics/fid.py`` (numpy only), so that the port
imports nothing of the JAX package; ``tests/test_torch_port_copies.py``
holds the two equal.

The statistics math is extractor-agnostic: any feature extractor (InceptionV3
once weights are supplied, or the CLIP image tower -> "CLIP-FID") plugs into
`compute_stats` + `frechet_distance`.  The reference shells out to
`pytorch_fid` (`utils/calculate_metrics.py:175-182`); here the math is
explicit and testable.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def compute_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[N, D] features -> (mu [D], sigma [D, D])."""
    feats = np.asarray(features, np.float64)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a symmetric PSD matrix via eigh."""
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """d^2 = |mu1-mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)).

    tr(sqrtm(S1 S2)) is computed via the symmetric form
    sqrtm(S1)^T S2 sqrtm(S1), avoiding a nonsymmetric sqrtm.
    """
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    s1 = np.asarray(sigma1, np.float64) + np.eye(len(mu1)) * eps
    s2 = np.asarray(sigma2, np.float64) + np.eye(len(mu2)) * eps
    diff = mu1 - mu2
    r1 = _sqrtm_psd(s1)
    covmean_tr = np.trace(_sqrtm_psd(r1 @ s2 @ r1))
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * covmean_tr)


def fid_from_features(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    return frechet_distance(*compute_stats(feats_a), *compute_stats(feats_b))
