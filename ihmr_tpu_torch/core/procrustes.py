"""Procrustes alignment used by evaluation metrics (a copy of
ihmr_tpu/core/procrustes.py: the JAX package's import pulls in jax).

ref: src/utils/metric_utils.py:59-117 (``calc_transform`` — full
similarity-transform Procrustes; ``calc_transform_no_rot`` — per-axis
mean/std renormalization). NumPy host-side implementations (metrics run on
host over per-sample results), with shapes (N, 3).
"""

from __future__ import annotations

import numpy as np


def similarity_align(S1: np.ndarray, S2: np.ndarray) -> np.ndarray:
    """Return S1 aligned onto S2 by the optimal scale/rotation/translation.

    Accepts (N, D) points with D in {2, 3} (transposes internally like the
    reference implementation)."""
    S1 = np.asarray(S1, np.float64)
    S2 = np.asarray(S2, np.float64)
    transposed = False
    if S1.shape[0] not in (2, 3):
        S1, S2 = S1.T, S2.T
        transposed = True
    assert S2.shape[1] == S1.shape[1]

    mu1 = S1.mean(axis=1, keepdims=True)
    mu2 = S2.mean(axis=1, keepdims=True)
    X1 = S1 - mu1
    X2 = S2 - mu2
    var1 = np.sum(X1**2)

    K = X1 @ X2.T
    U, _s, Vh = np.linalg.svd(K)
    V = Vh.T
    Z = np.eye(U.shape[0])
    Z[-1, -1] *= np.sign(np.linalg.det(U @ V.T))
    R = V @ Z @ U.T
    scale = np.trace(R @ K) / var1
    t = mu2 - scale * (R @ mu1)
    S1_hat = scale * R @ S1 + t
    return S1_hat.T if transposed else S1_hat


def no_rot_align(S1: np.ndarray, S2: np.ndarray) -> np.ndarray:
    """Translation/scale-only alignment: renormalize S1's per-axis mean/std
    onto S2's (ref metric_utils.py:107-117)."""
    S1 = np.asarray(S1, np.float64)
    S2 = np.asarray(S2, np.float64)
    mean1 = S1.mean(axis=0, keepdims=True)
    mean2 = S2.mean(axis=0, keepdims=True)
    std1 = S1.std(axis=0, keepdims=True)
    std2 = S2.std(axis=0, keepdims=True)
    return (S1 - mean1) / std1 * std2 + mean2
