"""Evaluation metrics: similarity alignment and absolute trajectory error.

`umeyama_alignment` and `aligned_rmse` are copies of the numpy functions in
sfm_danpipeline_tpu/utils/metrics.py (kept here so the port never imports
the JAX package); `camera_centers` uses the port's Rodrigues map.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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
    """RMSE after optimal similarity alignment (ATE for camera centers,
    structure error for points)."""
    s, R, t = umeyama_alignment(src, dst)
    err = (s * (src @ R.T) + t) - dst
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def camera_centers(cameras: np.ndarray) -> np.ndarray:
    """Camera centers -R^T t from (C, 6) angle-axis+t parameterization."""
    from sfm_danpipeline_torch.ops.lie import exp_so3

    cams = np.asarray(cameras, np.float32)
    R = exp_so3(torch.as_tensor(cams[:, :3])).numpy()
    return -np.einsum("cij,cj->ci", R.transpose(0, 2, 1), cams[:, 3:])
