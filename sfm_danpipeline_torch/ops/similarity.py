"""Sim(3) estimation: Umeyama alignment + RANSAC over 3D-3D pairs.

Port of sfm_danpipeline_tpu/ops/similarity.py. Components of a
reconstruction split by a viewpoint break are aligned with a similarity
estimated from cross-component 3D-3D correspondences (pipeline/merge.py):
a fixed budget of 3-point Umeyama hypotheses (one batched 3x3 SVD), MSAC
selection through ops/ransac.ransac, then two full-inlier refits.

The estimators score only the valid rows (the candidate table is padded to
a fixed size); invalid rows add nothing to an MSAC score and are never
inliers, so this is the reference's computation on fewer rows. `samples`
injects (n_hypotheses, 3) draws indexing the full table, as every RANSAC
estimator of the port does.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from sfm_danpipeline_torch.ops.lie import exp_so3
from sfm_danpipeline_torch.ops.ransac import ransac, sample_indices


class Sim3(NamedTuple):
    s: torch.Tensor  # () scale
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)


class Sim3Result(NamedTuple):
    sim: Sim3
    inliers: torch.Tensor  # (M,) bool
    n_inliers: torch.Tensor
    ok: torch.Tensor


def apply_sim3(sim: Sim3, X: torch.Tensor) -> torch.Tensor:
    """Y = s * R @ X + t, batched over leading dims of X (..., 3)."""
    return sim.s * (X @ sim.R.T) + sim.t


def umeyama(
    X: torch.Tensor, Y: torch.Tensor, w: Optional[torch.Tensor] = None
) -> Sim3:
    """Weighted least-squares similarity Y ~ s R X + t (Umeyama 1991).

    X, Y: (..., N, 3); w: (..., N) nonnegative weights (None = uniform).
    Leading dims batch independent fits. The SVD's per-column signs cancel
    in R = U S Vt and in the scale, so the result is backend-independent.
    """
    if w is None:
        w = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    wn = w / wsum
    mx = torch.sum(wn[..., None] * X, dim=-2)
    my = torch.sum(wn[..., None] * Y, dim=-2)
    Xc = X - mx[..., None, :]
    Yc = Y - my[..., None, :]
    cov = (wn[..., None] * Yc).transpose(-1, -2) @ Xc  # X-frame -> Y-frame
    U, D, Vt = torch.linalg.svd(cov)
    sgn = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    diag = torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], dim=-1)
    R = (U * diag[..., None, :]) @ Vt
    var_x = torch.sum(wn * torch.sum(Xc * Xc, dim=-1), dim=-1)
    s = torch.sum(D * diag, dim=-1) / torch.clamp(var_x, min=1e-12)
    t = my - s[..., None] * (R @ mx[..., None])[..., 0]
    return Sim3(s=s, R=R, t=t)


def _pack(sim: Sim3) -> torch.Tensor:
    """(..., 13) models: R row-major, t, s."""
    return torch.cat(
        [sim.R.reshape(sim.R.shape[:-2] + (9,)), sim.t, sim.s[..., None]], dim=-1
    )


def _unpack(model: torch.Tensor):
    return model[..., :9].reshape(model.shape[:-1] + (3, 3)), model[..., 9:12], model[..., 12]


def _sim3_ransac(
    key: Optional[torch.Tensor],
    X: torch.Tensor,
    Y: torch.Tensor,
    valid: torch.Tensor,
    residuals_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    threshold: float,
    n_hypotheses: int,
    min_inliers: int,
    samples: Optional[torch.Tensor],
) -> Sim3Result:
    """Shared body: 3-point Umeyama MSAC on the valid rows, two refits.
    residuals_fn(rows, R (H, 3, 3), t (H, 3), s (H,)) -> (H, |rows|). The
    draws are the reference's from `key` over the whole table (or the
    injected `samples`), read as positions among the valid rows."""
    rows = torch.nonzero(valid, as_tuple=True)[0]
    if rows.numel() == 0:
        eye = torch.eye(3, dtype=X.dtype, device=X.device)
        one = torch.ones((), dtype=X.dtype, device=X.device)
        no = torch.zeros_like(valid)
        return Sim3Result(
            sim=Sim3(s=one, R=eye, t=torch.zeros(3, dtype=X.dtype, device=X.device)),
            inliers=no, n_inliers=torch.sum(no), ok=torch.tensor(False, device=X.device),
        )
    Xv, Yv = X[rows], Y[rows]
    if samples is None:
        samples = sample_indices(key, valid, n_hypotheses, 3)
    # Full-table draws -> positions among the valid rows.
    samples = (torch.cumsum(valid.to(torch.int64), 0) - 1)[samples.long()]

    def fit(idx):
        return _pack(umeyama(Xv[idx], Yv[idx]))

    def residuals(models):
        R, t, s = _unpack(models)
        return residuals_fn(rows, R, t, s)

    all_valid = torch.ones_like(rows, dtype=torch.bool)
    _, inl_v, _ = ransac(
        None, fit, residuals, all_valid, n_hypotheses, 3, threshold, samples=samples
    )
    for _ in range(2):
        sim = umeyama(Xv, Yv, inl_v.to(X.dtype))
        inl_v = residuals_fn(rows, sim.R[None], sim.t[None], sim.s[None])[0] < threshold
    inliers = torch.zeros_like(valid)
    inliers[rows] = inl_v
    n_in = torch.sum(inliers)
    ok = (
        (n_in >= min_inliers) & torch.isfinite(sim.s) & (sim.s > 1e-6)
        & torch.all(torch.isfinite(sim.R)) & torch.all(torch.isfinite(sim.t))
    )
    return Sim3Result(sim=sim, inliers=inliers, n_inliers=n_in, ok=ok)


def estimate_sim3_reproj_ransac(
    key: Optional[torch.Tensor],
    X: torch.Tensor,  # (M, 3) source points (component B frame)
    Y: torch.Tensor,  # (M, 3) target points (component A frame)
    cams: torch.Tensor,  # (M, 6) per-pair A-frame camera (angle-axis + t)
    obs_xy: torch.Tensor,  # (M, 2) pixel observation in that camera
    K: torch.Tensor,  # (3, 3)
    valid: torch.Tensor,  # (M,)
    threshold_px: float,
    n_hypotheses: int = 4096,
    min_inliers: int = 8,
    samples: Optional[torch.Tensor] = None,
) -> Sim3Result:
    """Sim(3) RANSAC scored by 2D reprojection: each hypothesis maps X
    into A's frame and projects it through the pair's A-frame camera
    against the observed pixel (3D-3D scoring admits wrong-scale merges)."""
    Rc = exp_so3(cams[:, :3])
    tc = cams[:, 3:]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def reproj_err(rows, R, t, s):
        Xw = s[:, None, None] * (X[rows] @ R.transpose(-1, -2)) + t[:, None, :]
        cam = torch.einsum("mij,hmj->hmi", Rc[rows], Xw) + tc[rows]
        zc = cam[..., 2]
        z = torch.where(torch.abs(zc) < 1e-9, torch.full_like(zc, 1e-9), zc)
        u = cam[..., 0] / z * fx + cx
        v = cam[..., 1] / z * fy + cy
        o = obs_xy[rows]
        r = torch.sqrt((u - o[:, 0]) ** 2 + (v - o[:, 1]) ** 2)
        r = torch.where(zc > 0, r, torch.full_like(r, 1e9))
        return torch.where(torch.isfinite(r), r, torch.full_like(r, 1e9))

    return _sim3_ransac(
        key, X, Y, valid, reproj_err, threshold_px, n_hypotheses, min_inliers, samples
    )


def estimate_sim3_ransac(
    key: Optional[torch.Tensor],
    X: torch.Tensor,  # (M, 3) source points
    Y: torch.Tensor,  # (M, 3) target points
    valid: torch.Tensor,  # (M,)
    threshold: float,  # inlier distance in target units
    n_hypotheses: int = 2048,
    min_inliers: int = 8,
    samples: Optional[torch.Tensor] = None,
) -> Sim3Result:
    """RANSAC similarity from noisy 3D-3D correspondences. `ok` requires
    `min_inliers` support and a positive, finite scale."""

    def dist3(rows, R, t, s):
        pred = s[:, None, None] * (X[rows] @ R.transpose(-1, -2)) + t[:, None, :]
        r = torch.linalg.norm(pred - Y[rows], dim=-1)
        return torch.where(torch.isfinite(r), r, torch.full_like(r, 1e9))

    return _sim3_ransac(
        key, X, Y, valid, dist3, threshold, n_hypotheses, min_inliers, samples
    )
