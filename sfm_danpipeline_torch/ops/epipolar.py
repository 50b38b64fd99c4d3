"""Essential-matrix estimation and relative-pose recovery.

Port of sfm_danpipeline_tpu/ops/epipolar.py: the normalized 8-point
algorithm inside a fixed-budget RANSAC, Sampson scoring, cheirality-ranked
model selection among the best hypotheses, a Gauss-Newton polish of the
pose on the Sampson distance, and the basin-diverse second candidate that
the seed bootstrap and the pose graph consume.

Eigenvector and singular-vector signs are arbitrary (eigh, svd) and may
differ from the reference's; every quantity taken from them here (E up to
scale, poses after the cheirality test) is sign-invariant.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd

from sfm_danpipeline_torch.ops.lie import exp_so3, log_so3
from sfm_danpipeline_torch.ops.ransac import sample_indices
from sfm_danpipeline_torch.ops.select import top_k_indices
from sfm_danpipeline_torch.ops.triangulation import pose_matrix, triangulate_dlt


class RelativePose(NamedTuple):
    R: torch.Tensor  # (3, 3) world(cam1)->cam2
    t: torch.Tensor  # (3,) unit-norm baseline
    E: torch.Tensor  # (3, 3) essential matrix
    inliers: torch.Tensor  # (M,) bool
    n_inliers: torch.Tensor  # scalar int
    ok: torch.Tensor  # scalar bool

    def basin(self, b: int) -> "RelativePose":
        """Candidate `b` of a basin-stacked (2, ...) result."""
        return RelativePose(*(f[b] for f in self))


def _where(c, a, b):
    """Scalar-condition select between two same-shape tensors."""
    return torch.where(c.reshape(c.shape + (1,) * (a.dim() - c.dim())), a, b)


def _hartley_transform(x: torch.Tensor, w: torch.Tensor):
    """Weighted Hartley normalization, batched: x (..., M, 2), w (..., M) ->
    (normalized x, T (..., 3, 3))."""
    wsum = torch.sum(w, dim=-1) + 1e-12
    mean = torch.sum(x * w[..., None], dim=-2) / wsum[..., None]
    d = x - mean[..., None, :]
    rms = torch.sqrt(torch.sum(w * torch.sum(d * d, -1), dim=-1) / wsum) + 1e-12
    s = math.sqrt(2.0) / rms
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    T = torch.stack(
        [
            torch.stack([s, z, -s * mean[..., 0]], dim=-1),
            torch.stack([z, s, -s * mean[..., 1]], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )
    return d * s[..., None, None], T


def _fit_essential_dlt(x1, x2, w):
    """Weighted normalized 8-point fit, batched: x (..., M, 2), w (..., M)
    -> E (..., 3, 3) projected to singular values (s, s, 0)."""
    n1, T1 = _hartley_transform(x1, w)
    n2, T2 = _hartley_transform(x2, w)
    u1, v1 = n1[..., 0], n1[..., 1]
    u2, v2 = n2[..., 0], n2[..., 1]
    A = torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)],
        dim=-1,
    )
    Aw = A * w[..., None]
    _, V = torch.linalg.eigh(Aw.transpose(-1, -2) @ Aw)
    F = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    E = T2.transpose(-1, -2) @ F @ T1
    U, S, Vh = torch.linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) * 0.5
    diag = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    return (U * diag[..., None, :]) @ Vh


def essential_from_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """E = [t]x R."""
    z = torch.zeros_like(t[..., 0])
    t_hat = torch.stack(
        [
            torch.stack([z, -t[..., 2], t[..., 1]], dim=-1),
            torch.stack([t[..., 2], z, -t[..., 0]], dim=-1),
            torch.stack([-t[..., 1], t[..., 0], z], dim=-1),
        ],
        dim=-2,
    )
    return t_hat @ R


def sampson_distance(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """First-order epipolar distance in normalized coords. E (..., 3, 3),
    x (M, 2) -> (..., M)."""
    h1 = torch.cat([x1, torch.ones_like(x1[:, :1])], dim=-1)
    h2 = torch.cat([x2, torch.ones_like(x2[:, :1])], dim=-1)
    Ex1 = h1 @ E.transpose(-1, -2)
    Etx2 = h2 @ E
    num = torch.sum(h2 * Ex1, dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _refine_pose_sampson(R0, t0, x1, x2, w, iters: int = 10):
    """Gauss-Newton on (angle-axis, t) minimizing the weighted Sampson
    distance; t renormalized each step. A step is kept only if it lowers
    the cost. (The reference's lax.scan is this host loop.)"""
    params = torch.cat([log_so3(R0), t0])

    def resid(p):
        R = exp_so3(p[:3])
        t = p[3:] / (torch.linalg.norm(p[3:]) + 1e-12)
        return torch.sqrt(sampson_distance(essential_from_pose(R, t), x1, x2) + 1e-18) * w

    jac = jacfwd(resid)
    eye = 1e-8 * torch.eye(6, dtype=x1.dtype, device=x1.device)
    for _ in range(iters):
        r = resid(params)
        J = jac(params)
        delta = torch.linalg.solve_ex(J.T @ J + eye, J.T @ r)[0]
        new = params - delta
        better = torch.sum(resid(new) ** 2) < torch.sum(r**2)
        params = torch.where(better, new, params)
    R = exp_so3(params[:3])
    t = params[3:] / (torch.linalg.norm(params[3:]) + 1e-12)
    return R, t


def decompose_essential(E: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Four candidate (R, t): E (..., 3, 3) -> Rs (..., 4, 3, 3), ts (..., 4, 3)."""
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vh = Vh * torch.sign(torch.linalg.det(Vh))[..., None, None]
    W = torch.tensor(
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
        dtype=E.dtype, device=E.device,
    )
    Ra = U @ W @ Vh
    Rb = U @ W.T @ Vh
    t = U[..., :, 2]
    return torch.stack([Ra, Ra, Rb, Rb], dim=-3), torch.stack([t, -t, t, -t], dim=-2)


def _cheirality_counts(Rs, ts, x1, x2, mask):
    """Per candidate pose (..., 4): (near-in-front count, in-front count).
    Rs (..., 4, 3, 3), ts (..., 4, 3), x (M, 2), mask (..., M). The near
    gate (|z| < 50) only breaks ties (see the reference's note)."""
    eye = torch.eye(3, dtype=x1.dtype, device=x1.device)
    P1 = pose_matrix(eye, torch.zeros(3, dtype=x1.dtype, device=x1.device))
    P2 = pose_matrix(Rs, ts)
    X = triangulate_dlt(P1.expand(P2.shape), P2, x1, x2)  # (..., 4, M, 3)
    z1 = X[..., 2]
    z2 = torch.sum(X * Rs[..., None, 2, :], dim=-1) + ts[..., 2:3]
    front = (z1 > 0) & (z2 > 0) & mask[..., None, :]
    near = torch.abs(z1) < 50.0
    return torch.sum(front & near, dim=-1), torch.sum(front, dim=-1)


def rotation_angle_between(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Geodesic angle (radians) between rotations (batched)."""
    M = Ra @ Rb.transpose(-1, -2)
    c = (M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2] - 1.0) * 0.5
    return torch.arccos(torch.clamp(c, -1.0, 1.0))


# Basin separation (radians): rotations further apart than ~2 degrees are
# distinct interpretations of the epipolar geometry.
_BASIN_SEP = 0.035


def _eval_candidates(E, bands, x1, x2, M1):
    """Cheirality treatment of candidate models E (T, 3, 3) with their
    consensus bands (T, M): the best of each model's 4 decompositions by
    (front, near). Returns (rank, front, R, t), each with leading T."""
    Rs, ts = decompose_essential(E)
    near, front = _cheirality_counts(Rs, ts, x1, x2, bands)
    rank = front * M1 + near
    b = torch.argmax(rank, dim=-1)
    ar = torch.arange(E.shape[0], device=E.device)
    return rank[ar, b], front[ar, b], Rs[ar, b], ts[ar, b]


def _polish(R0, t0, band0, x1, x2, valid, refit_n2):
    """Two rounds of Sampson refinement, each re-collecting the band."""
    R, t, band = R0, t0, band0
    for _ in range(2):
        R, t = _refine_pose_sampson(R, t, x1, x2, band.to(x1.dtype))
        band = (sampson_distance(essential_from_pose(R, t), x1, x2) < refit_n2) & valid
    return R, t, band


def _pose_search(x1, x2, valid, refit_n2, idx):
    """Shared RANSAC head: 8-point hypotheses from the (H, 8) draws `idx`,
    MSAC scores, cheirality-ranked winner among the top 8, and the Sampson
    polish kept only when its in-front fraction is healthy."""
    models = _fit_essential_dlt(
        x1[idx], x2[idx], torch.ones(idx.shape, dtype=x1.dtype, device=x1.device)
    )
    res = sampson_distance(models, x1, x2)
    res = torch.where(valid[None, :], res, torch.zeros_like(res))
    scores = torch.sum(torch.clamp(res, max=refit_n2), dim=-1)
    top = top_k_indices(-scores, 8)
    M1 = x1.shape[0] + 1  # lexicographic rank base: front count dominates
    bands_t = (res[top] < refit_n2) & valid[None, :]
    ranks, fronts, Rs_c, ts_c = _eval_candidates(models[top], bands_t, x1, x2, M1)
    pick = torch.argmax(ranks)
    R0, t0, band0, front0 = Rs_c[pick], ts_c[pick], bands_t[pick], fronts[pick]

    R, t, band = _polish(R0, t0, band0, x1, x2, valid, refit_n2)
    Rs2, ts2 = decompose_essential(essential_from_pose(R, t))
    near2, front2 = _cheirality_counts(Rs2, ts2, x1, x2, band)
    best2 = torch.argmax(front2 * M1 + near2)
    refined_front = front2[best2]
    use_refined = refined_front >= torch.div(torch.sum(band) + 1, 2, rounding_mode="floor")
    return dict(
        models=models, scores=scores, res=res, M1=M1,
        R0=R0, t0=t0, band0=band0, front0=front0,
        R=_where(use_refined, Rs2[best2], R0),
        t=_where(use_refined, ts2[best2], t0),
        band=_where(use_refined, band, band0),
        front=torch.where(use_refined, refined_front, front0),
    )


def _finish(R, t, band, front, min_points) -> RelativePose:
    n_in = torch.sum(band)
    det_ok = torch.abs(torch.abs(torch.linalg.det(R)) - 1.0) < 1e-4
    ok = det_ok & (n_in >= min_points) & (front >= torch.div(n_in, 2, rounding_mode="floor"))
    return RelativePose(
        R=R, t=t, E=essential_from_pose(R, t), inliers=band, n_inliers=n_in, ok=ok
    )


def estimate_relative_pose(
    gen: Optional[torch.Generator],
    x1: torch.Tensor,
    x2: torch.Tensor,
    valid: torch.Tensor,
    focal: float | torch.Tensor,
    threshold_px: float = 1.0,
    n_hypotheses: int = 512,
    min_points: int = 8,
    samples: Optional[torch.Tensor] = None,
) -> RelativePose:
    """Two-view pose: RANSAC essential + polish + cheirality recoverPose.
    x1, x2: (M, 2) normalized coords; `samples` injects the (H, 8) draws."""
    refit_n2 = (2.5 * threshold_px / focal) ** 2
    idx = samples if samples is not None else sample_indices(gen, valid, n_hypotheses, 8)
    s = _pose_search(x1, x2, valid, refit_n2, idx)
    return _finish(s["R"], s["t"], s["band"], s["front"], min_points)


def estimate_relative_pose_basins(
    gen: Optional[torch.Generator],
    x1: torch.Tensor,
    x2: torch.Tensor,
    valid: torch.Tensor,
    focal: float | torch.Tensor,
    threshold_px: float = 1.0,
    n_hypotheses: int = 512,
    min_points: int = 8,
    samples: Optional[torch.Tensor] = None,
) -> RelativePose:
    """Two basin-diverse pose candidates stacked on a leading (2, ...) axis:
    candidate 0 is `estimate_relative_pose`'s answer; candidate 1 the best
    pose whose rotation lies > ~2 deg away (the unpolished winner if the
    polish jumped basins, else the best-MSAC alternative of the pool,
    polished with a basin guard). Third-view registration disambiguates."""
    refit_n2 = (2.5 * threshold_px / focal) ** 2
    idx = samples if samples is not None else sample_indices(gen, valid, n_hypotheses, 8)
    s = _pose_search(x1, x2, valid, refit_n2, idx)
    R_a, t_a = s["R"], s["t"]
    models, scores, res = s["models"], s["scores"], s["res"]

    jumped = rotation_angle_between(R_a, s["R0"]) > _BASIN_SEP
    Rs_m, _ = decompose_essential(models)
    dists = torch.minimum(
        rotation_angle_between(Rs_m[:, 0], R_a), rotation_angle_between(Rs_m[:, 2], R_a)
    )
    alt_scores = torch.where(dists > _BASIN_SEP, scores, torch.full_like(scores, math.inf))
    alt_top = top_k_indices(-alt_scores, 8)
    bands_alt = (res[alt_top] < refit_n2) & valid[None, :]
    ranks_alt, fronts_alt, Rs_alt, ts_alt = _eval_candidates(
        models[alt_top], bands_alt, x1, x2, s["M1"]
    )
    ranks_alt = torch.where(
        torch.isfinite(alt_scores[alt_top]), ranks_alt, torch.full_like(ranks_alt, -1)
    )
    pick_alt = torch.argmax(ranks_alt)
    has_alt = ranks_alt[pick_alt] >= 0

    R_b0 = _where(jumped, s["R0"], Rs_alt[pick_alt])
    t_b0 = _where(jumped, s["t0"], ts_alt[pick_alt])
    band_b0 = _where(jumped, s["band0"], bands_alt[pick_alt])
    front_b0 = torch.where(jumped, s["front0"], fronts_alt[pick_alt])
    usable_b = jumped | has_alt

    R_b, t_b, band_b = _polish(R_b0, t_b0, band_b0, x1, x2, valid, refit_n2)
    stayed = rotation_angle_between(R_b, R_a) > _BASIN_SEP
    Rs_b2, ts_b2 = decompose_essential(essential_from_pose(R_b, t_b))
    near_b2, front_b2 = _cheirality_counts(Rs_b2, ts_b2, x1, x2, band_b)
    best_b2 = torch.argmax(front_b2 * s["M1"] + near_b2)
    keep_pol = stayed & (
        front_b2[best_b2] >= torch.div(torch.sum(band_b) + 1, 2, rounding_mode="floor")
    )
    R_b = _where(keep_pol, Rs_b2[best_b2], R_b0)
    t_b = _where(keep_pol, ts_b2[best_b2], t_b0)
    band_b = _where(keep_pol, band_b, band_b0)
    front_b = torch.where(keep_pol, front_b2[best_b2], front_b0)

    cand_a = _finish(R_a, t_a, s["band"], s["front"], min_points)
    cand_b = _finish(R_b, t_b, band_b, front_b, min_points)
    cand_b = cand_b._replace(ok=cand_b.ok & usable_b)
    return RelativePose(*(torch.stack([a, b]) for a, b in zip(cand_a, cand_b)))
