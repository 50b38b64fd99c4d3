"""Homography estimation (4-point DLT) with fixed-budget RANSAC.

Port of sfm_danpipeline_tpu/ops/homography.py (the reference's
findHomography RANSAC used for pair scoring, src/Sfm.cpp:667-689).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from sfm_danpipeline_torch.ops.lie import matmul3
from sfm_danpipeline_torch.ops.ransac import gather_rows, linalg_in_slices, ransac
from sfm_danpipeline_torch.ops.reduce import fixed_sum


def _similarity(s, mx, my):
    """(..., 3, 3) similarity [[s, 0, -s mx], [0, s, -s my], [0, 0, 1]]."""
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    return torch.stack(
        [
            torch.stack([s, z, -s * mx], dim=-1),
            torch.stack([z, s, -s * my], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )


def _similarity_inv(s, mx, my):
    """Inverse of `_similarity(s, mx, my)`."""
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    inv = 1.0 / s
    return torch.stack(
        [
            torch.stack([inv, z, mx], dim=-1),
            torch.stack([z, inv, my], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )


def _dlt_rows(n1: torch.Tensor, n2: torch.Tensor) -> torch.Tensor:
    """(..., 2M, 9) homography DLT rows from normalized (..., M, 2) pairs."""
    x, y = n1[..., 0], n1[..., 1]
    u, v = n2[..., 0], n2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], dim=-1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], dim=-1)
    return r1, r2


def _denormalize(Hn, s1, m1, s2, m2):
    T1 = _similarity(s1, m1[..., 0], m1[..., 1])
    T2inv = _similarity_inv(s2, m2[..., 0], m2[..., 1])
    H = matmul3(matmul3(T2inv, Hn), T1)
    h22 = H[..., 2, 2]
    h22 = torch.where(torch.abs(h22) < 1e-12, torch.full_like(h22, 1e-12), h22)
    return H / h22[..., None, None]


def _homography_from_four(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """DLT from 4 correspondences, batched: x1, x2 (..., 4, 2) pixels ->
    (..., 3, 3) mapping x1 -> x2, Hartley-normalized for f32 conditioning."""

    def norm(x):
        mean = torch.mean(x, dim=-2)
        rms = torch.sqrt(torch.mean(torch.sum((x - mean[..., None, :]) ** 2, -1), -1)) + 1e-12
        s = math.sqrt(2.0) / rms
        return (x - mean[..., None, :]) * s[..., None, None], s, mean

    n1, s1, m1 = norm(x1)
    n2, s2, m2 = norm(x2)
    r1, r2 = _dlt_rows(n1, n2)
    # Row order of the reference: (r1_0, r2_0, r1_1, r2_1, ...).
    A = torch.stack([r1, r2], dim=-2).reshape(x1.shape[:-2] + (-1, 9))
    _, V = linalg_in_slices(torch.linalg.eigh, A.transpose(-1, -2) @ A)
    Hn = V[..., :, 0].reshape(x1.shape[:-2] + (3, 3))
    return _denormalize(Hn, s1, m1, s2, m2)


def transfer_error(H: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Forward transfer error |H x1 - x2| in pixels. H (..., 3, 3), x (...,
    M, 2) with leading dims broadcasting against H's -> (..., M)."""
    x, y = x1[..., 0], x1[..., 1]
    p = [H[..., i, 0, None] * x + H[..., i, 1, None] * y + H[..., i, 2, None] for i in range(3)]
    w = torch.where(torch.abs(p[2]) < 1e-12, torch.full_like(p[2], 1e-12), p[2])
    dx = p[0] / w - x2[..., 0]
    dy = p[1] / w - x2[..., 1]
    return torch.sqrt(dx * dx + dy * dy)


def _homography_refit(x1, x2, w):
    """Weighted DLT refit over each problem's inlier set: x (..., M, 2),
    w (..., M) 0/1 weights -> (..., 3, 3)."""
    wsum = fixed_sum(w) + 1e-12

    def centre(x):
        m = fixed_sum((x * w[..., None]).transpose(-1, -2)) / wsum[..., None]
        d = x - m[..., None, :]
        r = torch.sqrt(fixed_sum(w * (d[..., 0] ** 2 + d[..., 1] ** 2)) / wsum) + 1e-12
        s = math.sqrt(2.0) / r
        return d * s[..., None, None], s, m

    n1, s1, m1 = centre(x1)
    n2, s2, m2 = centre(x2)
    rows1, rows2 = _dlt_rows(n1, n2)
    A = torch.cat([rows1 * w[..., None], rows2 * w[..., None]], dim=-2).transpose(-1, -2)
    _, V = linalg_in_slices(torch.linalg.eigh, fixed_sum(A[..., :, None, :] * A[..., None, :, :]))
    Hn = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    return _denormalize(Hn, s1, m1, s2, m2)


def homography_ransac(
    key: Optional[torch.Tensor],
    x1: torch.Tensor,
    x2: torch.Tensor,
    valid: torch.Tensor,
    threshold: float | torch.Tensor,
    n_hypotheses: int = 256,
    samples: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RANSAC homography + weighted refit on the inliers. Returns (H,
    inlier_mask, n_inliers); threshold is the pixel transfer error. x1, x2
    (M, 2), valid (M,) and key (2,) for one problem, or (P, M, 2), (P, M)
    and (P, 2) for P at once (`samples` (H, 4) or (P, H, 4) in place of the
    key's draws); a batch's outputs gain the P."""
    H, inliers, _ = ransac(
        key,
        lambda idx: _homography_from_four(gather_rows(x1, idx), gather_rows(x2, idx)),
        lambda Hs: transfer_error(Hs, x1[..., None, :, :], x2[..., None, :, :]),
        valid, n_hypotheses, 4, threshold, samples=samples,
    )
    H = _homography_refit(x1, x2, inliers.to(x1.dtype))
    inliers = (transfer_error(H, x1, x2) < threshold) & valid
    return H, inliers, torch.sum(inliers, dim=-1)
