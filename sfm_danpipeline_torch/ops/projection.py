"""Camera projection, undistortion, and reprojection-error primitives.

Port of sfm_danpipeline_tpu/ops/projection.py. Cameras are world-to-camera
[R | t]: x_cam = R @ X + t.
"""
from __future__ import annotations

import torch

from sfm_danpipeline_torch.ops.interp import bilinear_sample


def _safe_z(z: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)


def distort_normalized(xn: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Forward 5-coefficient OpenCV distortion (k1, k2, p1, p2, k3) on
    normalized coords xn (..., 2)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def project(
    X: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    K: torch.Tensor,
    dist: torch.Tensor | None = None,
) -> torch.Tensor:
    """Project world points into pixels. X: (..., 3) -> (..., 2)."""
    x_cam = X @ R.T + t
    x_n = x_cam[..., :2] / _safe_z(x_cam[..., 2:3], 1e-12)
    if dist is not None:
        x_n = distort_normalized(x_n, dist)
    return torch.stack(
        [x_n[..., 0] * K[0, 0] + K[0, 2], x_n[..., 1] * K[1, 1] + K[1, 2]],
        dim=-1,
    )


def project_normalized(X: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Project into normalized camera coordinates (z-divide, no K)."""
    x_cam = X @ R.T + t
    return x_cam[..., :2] / _safe_z(x_cam[..., 2:3], 1e-12)


def depths(X: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Camera-frame z of world points (the cheirality test's input)."""
    return X @ R[2] + t[2]


def undistort_points(
    pts: torch.Tensor, K: torch.Tensor, dist: torch.Tensor, iters: int = 5
) -> torch.Tensor:
    """Pixels -> normalized camera coords, inverting the distortion by
    fixed-point iteration (cv::undistortPoints semantics). pts: (..., 2)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    x = (pts[..., 0] - cx) / fx
    y = (pts[..., 1] - cy) / fy
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x0, y0 = x, y
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return torch.stack([x, y], dim=-1)


def undistort_image(
    img: torch.Tensor, K: torch.Tensor, dist: torch.Tensor
) -> torch.Tensor:
    """Resample a distorted image (H, W) or (H, W, C) onto the ideal pinhole
    grid with the same K (cv::undistort semantics): each ideal pixel reads
    its source through the forward distortion model, bilinearly."""
    H, W = img.shape[:2]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    v, u = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=img.device),
        torch.arange(W, dtype=torch.float32, device=img.device),
        indexing="ij",
    )
    xd = distort_normalized(torch.stack([(u - cx) / fx, (v - cy) / fy], dim=-1), dist)
    us = xd[..., 0] * fx + cx
    vs = xd[..., 1] * fy + cy
    if img.ndim == 2:
        return bilinear_sample(img, us, vs)
    return torch.stack(
        [bilinear_sample(img[..., c], us, vs) for c in range(img.shape[-1])], dim=-1
    )


def reprojection_error(
    X: torch.Tensor,
    obs: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    K: torch.Tensor,
) -> torch.Tensor:
    """Euclidean pixel reprojection error per point."""
    return torch.linalg.norm(project(X, R, t, K) - obs, dim=-1)
