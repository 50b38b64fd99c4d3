"""Batched DLT triangulation with reprojection filtering.

Port of sfm_danpipeline_tpu/ops/triangulation.py: the inhomogeneous
two-view DLT (fix W=1) solved through its 3x3 normal equations in closed
form, batched over points.
"""
from __future__ import annotations

from typing import Tuple

import torch

from sfm_danpipeline_torch.ops.projection import project


def pose_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[R | t] as a (..., 3, 4) projection (normalized camera, no K)."""
    return torch.cat([R, t[..., :, None]], dim=-1)


def _solve3(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 SPD solve via the adjugate. H: (..., 3, 3),
    g: (..., 3)."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 1], H[..., 1, 2], H[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    x = A * g[..., 0] + B * g[..., 1] + C * g[..., 2]
    y = B * g[..., 0] + D * g[..., 1] + E * g[..., 2]
    z = C * g[..., 0] + E * g[..., 1] + F * g[..., 2]
    return torch.stack([x, y, z], dim=-1) / det[..., None]


def triangulate_dlt(
    P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> torch.Tensor:
    """Two-view DLT. P1, P2: (..., 3, 4) normalized projections; x1, x2:
    (..., N, 2) normalized image points. Returns (..., N, 3)."""
    P1 = P1[..., None, :, :]
    P2 = P2[..., None, :, :]
    A = torch.stack(
        [
            x1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
            x1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
            x2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
            x2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
        ],
        dim=-2,
    )  # (..., N, 4, 4)
    M = A[..., :3]
    b = A[..., 3]
    H = M.transpose(-1, -2) @ M + 1e-12 * torch.eye(
        3, dtype=A.dtype, device=A.device
    )
    g = (M.transpose(-1, -2) @ b[..., None])[..., 0]
    return -_solve3(H, g)


def triangulate_and_filter(
    R1: torch.Tensor,
    t1: torch.Tensor,
    R2: torch.Tensor,
    t2: torch.Tensor,
    x1n: torch.Tensor,
    x2n: torch.Tensor,
    px1: torch.Tensor,
    px2: torch.Tensor,
    K: torch.Tensor,
    valid: torch.Tensor,
    max_error_px: float = 6.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Triangulate matched observations and keep points that reproject
    within `max_error_px` in both views and lie in front of both cameras.
    Returns (points (N,3), keep (N,))."""
    X = triangulate_dlt(pose_matrix(R1, t1), pose_matrix(R2, t2), x1n, x2n)
    e1 = torch.linalg.norm(project(X, R1, t1, K) - px1, dim=-1)
    e2 = torch.linalg.norm(project(X, R2, t2, K) - px2, dim=-1)
    z1 = X @ R1[2] + t1[2]
    z2 = X @ R2[2] + t2[2]
    keep = (
        valid
        & (e1 <= max_error_px)
        & (e2 <= max_error_px)
        & (z1 > 0)
        & (z2 > 0)
    )
    return X, keep
