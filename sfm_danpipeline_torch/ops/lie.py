"""SO(3) utilities: angle-axis (Rodrigues) exp/log maps.

Port of sfm_danpipeline_tpu/ops/lie.py. Pure tensor functions with Taylor
branches near the identity, written without in-place ops so that
`torch.func.jacfwd` and `torch.func.vmap` can trace them (BA residuals,
PnP and Sampson refinement differentiate through `rotate_point` and
`exp_so3`).
"""
from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector. w: (..., 3) -> (..., 3, 3)."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def matmul3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for (..., 3, 3) matrices as elementwise products and sums. A
    batch of one goes through another cuBLAS kernel than a larger batch and
    rounds differently; this form gives each matrix the same bits in any
    batch."""
    return sum(A[..., :, k, None] * B[..., None, k, :] for k in range(3))


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: angle-axis (..., 3) -> rotation matrix (..., 3, 3)."""
    # keepdim: 0-dim intermediates mixed with Python scalars come out
    # float64 under torch.func.jacfwd; (..., 1) shapes stay float32.
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = theta2 < 1e-8
    # Double-where: the unused branch gets a safe input so its derivative
    # stays finite.
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe
    )
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None] * W + b[..., None] * matmul3(W, W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> angle-axis (..., 3); valid for
    theta in [0, pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = torch.sin(theta)
    small = theta < 1e-6
    scale = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * torch.where(small, torch.ones_like(sin_theta), sin_theta)),
    )
    return v * scale[..., None]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def rotate_point(w: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate point(s) p (..., 3) by angle-axis w (..., 3) without forming R
    (the ceres::AngleAxisRotatePoint form the BA residual uses)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    cos_t = torch.where(small, 1.0 - theta2 / 2.0, torch.cos(theta))
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cross = _cross(w, p)
    dot = torch.sum(w * p, dim=-1, keepdim=True)
    one_m_cos_over_t2 = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - cos_t) / theta2_safe
    )
    return p * cos_t + cross * sinc + w * dot * one_m_cos_over_t2
