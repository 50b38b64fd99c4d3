"""PnP pose estimation: DLT-PnP and P3P RANSAC + Gauss-Newton refinement.

Port of sfm_danpipeline_tpu/ops/pnp.py (the reference's solvePnPRansac +
plausibility guards, src/Sfm.cpp:1137-1210): a pool of 6-point DLT and
3-point P3P (multi-start Newton) hypotheses, two-stage MSAC selection, an
8 px second-chance recount, two Gauss-Newton refinements, and the
tight-consensus acceptance gate. Hypothesis batches are leading dims.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd

from sfm_danpipeline_torch.ops import prng
from sfm_danpipeline_torch.ops.lie import exp_so3, log_so3, rotate_point
from sfm_danpipeline_torch.ops.ransac import sample_indices
from sfm_danpipeline_torch.ops.select import top_k_indices


# RANSAC prescores every hypothesis on this many valid rows, then
# full-scores the best 384.
PRESCORE_ROWS = 256


class PnPResult(NamedTuple):
    R: torch.Tensor  # (3,3)
    t: torch.Tensor  # (3,)
    inliers: torch.Tensor  # (M,) bool
    n_inliers: torch.Tensor
    ok: torch.Tensor


def _safe(x: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


def _dlt_pnp(X: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Minimal DLT camera fit, batched: X (H, S, 3) world, x (H, S, 2)
    normalized image -> (H, 3, 4) [R|t] with R projected to SO(3) and the
    overall sign fixed by the sample's cheirality. (Singular-vector signs
    cancel: R = U diag(sign det) Vh is sign-invariant.)"""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    zeros = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zeros, -x[..., :1] * Xh], dim=-1)
    r2 = torch.cat([zeros, Xh, -x[..., 1:2] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    P = V[..., :, 0].reshape(X.shape[:-2] + (3, 4))
    M = P[..., :3]

    def orth(Mx, tcol):
        U, S, Vh = torch.linalg.svd(Mx)
        sg = torch.sign(torch.linalg.det(U @ Vh))
        R = (U * sg[..., None, None]) @ Vh
        scale = torch.mean(S, dim=-1) * sg
        return R, tcol / _safe(scale, 1e-12)[..., None]

    R, t = orth(M, P[..., 3])
    z = torch.sum(X * R[..., None, 2, :], dim=-1) + t[..., None, 2]
    flip = torch.sum(torch.sign(z), dim=-1) < 0
    # P and -P are the same projective camera: rebuild from -P.
    R2, t2 = orth(-M, -P[..., 3])
    R = torch.where(flip[..., None, None], R2, R)
    t = torch.where(flip[..., None], t2, t)
    return torch.cat([R, t[..., None]], dim=-1)


# (u, v) = (s2/s1, s3/s1) depth-ratio starting points for the multi-start
# P3P Newton.
_P3P_STARTS = np.array(
    [[1.0, 1.0], [0.6, 1.0], [1.0, 0.6], [1.8, 1.0], [1.0, 1.8], [0.6, 0.6], [1.8, 1.8]],
    np.float32,
)


def _p3p_solve(X3: torch.Tensor, y3: torch.Tensor) -> torch.Tensor:
    """Minimal 3-point pose, batched: X3 (H, 3, 3) world points, y3
    (H, 3, 3) unit bearings -> (H, 7, 3, 4), one candidate per Newton
    start (damped Newton on the depth-ratio system; failed starts return a
    sentinel pose at translation 1e12 that scoring discards)."""
    d12 = torch.sum((X3[:, 0] - X3[:, 1]) ** 2, -1)[:, None]
    d13 = torch.sum((X3[:, 0] - X3[:, 2]) ** 2, -1)[:, None]
    d23 = torch.sum((X3[:, 1] - X3[:, 2]) ** 2, -1)[:, None]
    c12 = torch.sum(y3[:, 0] * y3[:, 1], -1)[:, None]
    c13 = torch.sum(y3[:, 0] * y3[:, 2], -1)[:, None]
    c23 = torch.sum(y3[:, 1] * y3[:, 2], -1)[:, None]
    starts = torch.as_tensor(_P3P_STARTS, device=X3.device)
    H = X3.shape[0]
    u = starts[:, 0].expand(H, -1)
    v = starts[:, 1].expand(H, -1)

    def system(u, v):
        g12 = 1.0 + u * u - 2.0 * u * c12
        g13 = 1.0 + v * v - 2.0 * v * c13
        g23 = u * u + v * v - 2.0 * u * v * c23
        return g12, g13, g23

    for _ in range(12):
        g12, g13, g23 = system(u, v)
        F1 = g12 * d13 - g13 * d12
        F2 = g12 * d23 - g23 * d12
        J11 = (2.0 * u - 2.0 * c12) * d13
        J12 = -(2.0 * v - 2.0 * c13) * d12
        J21 = (2.0 * u - 2.0 * c12) * d23 - (2.0 * u - 2.0 * v * c23) * d12
        J22 = -(2.0 * v - 2.0 * u * c23) * d12
        det = _safe(J11 * J22 - J12 * J21, 1e-12)
        du = (F1 * J22 - F2 * J12) / det
        dv = (J11 * F2 - J21 * F1) / det
        u = torch.clamp(u - torch.clamp(du, -0.5, 0.5), 1e-3, 1e3)
        v = torch.clamp(v - torch.clamp(dv, -0.5, 0.5), 1e-3, 1e3)
    g12, g13, g23 = system(u, v)
    scale = d12 + d13 + d23 + 1e-12
    r1 = torch.abs(g12 * d13 - g13 * d12) / scale
    r2 = torch.abs(g12 * d23 - g23 * d12) / scale
    s1 = torch.sqrt(torch.clamp(d12 / torch.clamp(g12, min=1e-12), min=0.0))
    ok = (r1 < 1e-4) & (r2 < 1e-4) & (s1 > 0) & (g12 > 1e-12)
    P = torch.stack(
        [s1[..., None] * y3[:, None, 0], (u * s1)[..., None] * y3[:, None, 1],
         (v * s1)[..., None] * y3[:, None, 2]],
        dim=-2,
    )  # (H, 7, 3, 3) camera-frame points
    Xw = X3[:, None].expand_as(P)
    cw = torch.mean(Xw, dim=-2)
    cc = torch.mean(P, dim=-2)
    C = (P - cc[..., None, :]).transpose(-1, -2) @ (Xw - cw[..., None, :])
    U, _, Vh = torch.linalg.svd(C)
    sgn = torch.sign(torch.linalg.det(U @ Vh))
    diag = torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], dim=-1)
    R = (U * diag[..., None, :]) @ Vh
    t = cc - (R @ cw[..., None])[..., 0]
    eye = torch.eye(3, dtype=X3.dtype, device=X3.device)
    R = torch.where(ok[..., None, None], R, eye)
    t = torch.where(ok[..., None], t, torch.full_like(t, 1e12))
    return torch.cat([R, t[..., None]], dim=-1)


def _reproj_errors_px(Rt: torch.Tensor, X: torch.Tensor, px: torch.Tensor, K: torch.Tensor):
    """Pixel reprojection errors, inf behind the camera. Rt (..., 3, 4),
    X (M, 3), px (M, 2) -> (..., M)."""
    R, t = Rt[..., :3], Rt[..., 3]
    cam = X @ R.transpose(-1, -2) + t[..., None, :]
    uv = cam[..., :2] / _safe(cam[..., 2:3], 1e-9)
    f = torch.stack([K[0, 0], K[1, 1]])
    c = torch.stack([K[0, 2], K[1, 2]])
    err = torch.linalg.norm(uv * f + c - px, dim=-1)
    return torch.where(cam[..., 2] > 0, err, torch.full_like(err, float("inf")))


def _gauss_newton_refine(R, t, X, px, K, w, iters: int = 8):
    """Masked Gauss-Newton on (angle-axis, t) minimizing pixel
    reprojection; a step is kept only if it lowers the cost."""
    params = torch.cat([log_so3(R), t])
    f = torch.stack([K[0, 0], K[1, 1]])
    c = torch.stack([K[0, 2], K[1, 2]])

    def residual(p):
        cam = rotate_point(p[None, :3], X) + p[3:]
        uv = cam[:, :2] / _safe(cam[:, 2:3], 1e-9)
        return ((uv * f + c - px) * w[:, None]).reshape(-1)

    jac = jacfwd(residual)
    eye = 1e-6 * torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        r = residual(params)
        J = jac(params)
        delta = torch.linalg.solve_ex(J.T @ J + eye, J.T @ r)[0]
        new = params - delta
        better = torch.sum(residual(new) ** 2) < torch.sum(r**2)
        params = torch.where(better, new, params)
    return exp_so3(params[:3]), params[3:]


def pnp_sample_draws(
    key: torch.Tensor,
    valid: torch.Tensor,
    n_hypotheses: int,
    sample_size: int,
    sample_mask: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (DLT, P3P) index draws of `solve_pnp_ransac`, from the key
    split three ways (DLT, P3P, strict P3P) as the reference splits it: a
    quarter budget (at least 256) of `sample_size`-point DLT draws; P3P
    draws over the valid rows, half of them from the strict `sample_mask`
    subset when it holds >= 8 rows."""
    k_dlt, k_p3p, k_p3s = prng.split(key, 3).unbind(-2)
    idx6 = sample_indices(k_dlt, valid, max(256, n_hypotheses // 4), sample_size)
    if sample_mask is None:
        return idx6, sample_indices(k_p3p, valid, n_hypotheses, 3)
    strict = sample_mask & valid
    mask_eff = torch.where(torch.sum(strict) >= 8, strict, valid)
    idx3a = sample_indices(k_p3p, valid, n_hypotheses // 2, 3)
    idx3b = sample_indices(k_p3s, mask_eff, n_hypotheses // 2, 3)
    return idx6, torch.cat([idx3a, idx3b])


def solve_pnp_ransac(
    key: Optional[torch.Tensor],
    X: torch.Tensor,
    px: torch.Tensor,
    xn: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    threshold_px: float | torch.Tensor,
    n_hypotheses: int = 1024,
    sample_size: int = 6,
    max_translation: float = 200.0,
    min_inliers: int = 6,
    sample_mask: Optional[torch.Tensor] = None,
    samples: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    prescore_strict_first: bool = False,
) -> PnPResult:
    """RANSAC PnP over 2D-3D correspondences. X (M,3) world points, px
    (M,2) pixels, xn (M,2) normalized obs, valid (M,). `samples` injects
    the (DLT, P3P) draws of `pnp_sample_draws`.

    The prescore subset is the first 256 valid rows in row order, as the
    reference takes it. With `prescore_strict_first` it is the first 256
    valid rows of `sample_mask` (then the other valid rows), a departure
    from the reference: registration orders its loose-only rows first, and
    where more than 256 of them are outliers the reference's subset holds
    no true row, so every hypothesis the prescore keeps is wrong."""
    idx6, idx3 = samples if samples is not None else pnp_sample_draws(
        key, valid, n_hypotheses, sample_size, sample_mask
    )
    models6 = _dlt_pnp(X[idx6], xn[idx6])
    h = torch.cat([xn, torch.ones_like(xn[:, :1])], dim=-1)
    y = h / torch.linalg.norm(h, dim=-1, keepdim=True)
    models3 = _p3p_solve(X[idx3], y[idx3])
    models = torch.cat([models6, models3.reshape(-1, 3, 4)])

    # Two-stage MSAC: prescore every hypothesis on the first 256 valid
    # rows, full-score the top 384; strict rows weigh double.
    score_w = (
        1.0 + (sample_mask & valid).to(X.dtype) if sample_mask is not None
        else torch.ones_like(valid, dtype=X.dtype)
    )
    S = min(PRESCORE_ROWS, X.shape[0])
    rank = (~valid).to(torch.int8)
    if prescore_strict_first and sample_mask is not None:
        rank = rank * 2 + (~sample_mask).to(torch.int8)
    order = torch.argsort(rank, stable=True)[:S]
    sub_valid = valid[order]
    pres = torch.clamp(_reproj_errors_px(models, X[order], px[order], K), max=1e9)
    pres = torch.where(sub_valid[None, :], pres, torch.zeros_like(pres))
    pre_scores = torch.sum(score_w[order][None, :] * torch.clamp(pres, max=threshold_px), dim=-1)
    T = min(384, models.shape[0])
    top = top_k_indices(-pre_scores, T)
    res = torch.clamp(_reproj_errors_px(models[top], X, px, K), max=1e9)
    res = torch.where(valid[None, :], res, torch.zeros_like(res))
    scores = torch.sum(score_w[None, :] * torch.clamp(res, max=threshold_px), dim=-1)
    best = torch.argmin(scores)
    Rt = models[top[best]]
    inliers = (res[best] < threshold_px) & valid
    n_in = torch.sum(inliers)

    # Second chance: thin support is recounted at 8 px.
    loose = (_reproj_errors_px(Rt, X, px, K) < 8.0) & valid
    use_loose = n_in < torch.clamp(torch.div(torch.sum(valid), 5, rounding_mode="floor"), min=10)
    inliers = torch.where(use_loose, loose, inliers)

    R, t = _gauss_newton_refine(Rt[:, :3], Rt[:, 3], X, px, K, inliers.to(X.dtype))
    err1 = _reproj_errors_px(torch.cat([R, t[:, None]], -1), X, px, K)
    w2 = ((err1 < 8.0) & valid).to(X.dtype)
    R, t = _gauss_newton_refine(R, t, X, px, K, w2)
    err = _reproj_errors_px(torch.cat([R, t[:, None]], -1), X, px, K)
    # Acceptance: the tight consensus only.
    inliers = (err < threshold_px) & valid
    n_in = torch.sum(inliers)
    center = -R.T @ t
    ok = (
        (torch.abs(torch.linalg.det(R) - 1.0) < 1e-3)
        & (torch.linalg.norm(center) <= max_translation)
        & (n_in >= max(sample_size, min_inliers))
    )
    return PnPResult(R=R, t=t, inliers=inliers, n_inliers=n_in, ok=ok)
