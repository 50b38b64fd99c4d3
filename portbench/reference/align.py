"""Similarity alignment and trajectory error.

`umeyama_alignment` and `aligned_rmse` are frozen copies of the functions of
the same name in sfm_danpipeline_torch/utils/metrics.py (themselves copies of
sfm_danpipeline_tpu/utils/metrics.py), kept here so that later changes to the
program cannot move the yardstick. `rodrigues` is the angle-axis map in
float64 numpy.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity s, R, t minimizing ||s R src + t - dst||^2.

    src, dst: (N, 3). Returns (s, R (3,3), t (3,)).
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def aligned_rmse(src: np.ndarray, dst: np.ndarray) -> float:
    """RMSE after optimal similarity alignment (ATE for camera centers)."""
    s, R, t = umeyama_alignment(src, dst)
    err = (s * (src @ R.T) + t) - dst
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def rodrigues(w: np.ndarray) -> np.ndarray:
    """Angle-axis (..., 3) -> rotation matrices (..., 3, 3), float64."""
    w = np.asarray(w, np.float64)
    theta = np.linalg.norm(w, axis=-1)[..., None, None]
    k = w / np.maximum(theta[..., 0], 1e-300)
    Kx = np.zeros(w.shape[:-1] + (3, 3))
    Kx[..., 0, 1], Kx[..., 0, 2] = -k[..., 2], k[..., 1]
    Kx[..., 1, 0], Kx[..., 1, 2] = k[..., 2], -k[..., 0]
    Kx[..., 2, 0], Kx[..., 2, 1] = -k[..., 1], k[..., 0]
    return np.eye(3) + np.sin(theta) * Kx + (1.0 - np.cos(theta)) * (Kx @ Kx)
