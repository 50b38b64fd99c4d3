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
from collections import OrderedDict
from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd

from sfm_danpipeline_torch.ops.lie import exp_so3, log_so3, matmul3
from sfm_danpipeline_torch.ops.ransac import gather_rows, linalg_in_slices, pick, sample_indices, take
from sfm_danpipeline_torch.ops.reduce import fixed_sum
from sfm_danpipeline_torch.ops.select import top_k_indices
from sfm_danpipeline_torch.ops.triangulation import pose_matrix, triangulate_dlt
from sfm_danpipeline_torch.utils import profiling
from sfm_danpipeline_torch.utils.cuda_graphs import CapturedChain, cached_graph


class RelativePose(NamedTuple):
    """One pair's fields; a batch of pairs puts P in front of each."""

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
    """Select per problem: c (L...) between a and b (L..., *rest)."""
    return torch.where(c.reshape(c.shape + (1,) * (a.dim() - c.dim())), a, b)


def _hartley_transform(x: torch.Tensor, w: torch.Tensor):
    """Weighted Hartley normalization, batched: x (..., M, 2), w (..., M) ->
    (normalized x, T (..., 3, 3))."""
    wsum = fixed_sum(w) + 1e-12
    mean = fixed_sum((x * w[..., None]).transpose(-1, -2)) / wsum[..., None]
    d = x - mean[..., None, :]
    rms = torch.sqrt(fixed_sum(w * (d[..., 0] ** 2 + d[..., 1] ** 2)) / wsum) + 1e-12
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
        dim=-2,
    )  # (..., 9, M)
    Aw = A * w[..., None, :]
    _, V = linalg_in_slices(torch.linalg.eigh, fixed_sum(Aw[..., :, None, :] * Aw[..., None, :, :]))
    F = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    E = T2.transpose(-1, -2) @ F @ T1
    U, S, Vh = linalg_in_slices(torch.linalg.svd, E)
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
    return matmul3(t_hat, R)


def sampson_distance(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """First-order epipolar distance in normalized coords. E (..., 3, 3),
    x (..., M, 2) with leading dims broadcasting against E's -> (..., M).
    Elementwise, so a pair's distances do not depend on the batch around it."""
    x, y = x1[..., 0], x1[..., 1]
    u, v = x2[..., 0], x2[..., 1]
    e = [[E[..., i, j, None] for j in range(3)] for i in range(3)]
    ex = [e[i][0] * x + e[i][1] * y + e[i][2] for i in range(3)]  # E x1
    etx = [e[0][j] * u + e[1][j] * v + e[2][j] for j in range(2)]  # E^T x2
    num = (u * ex[0] + v * ex[1] + ex[2]) ** 2
    den = ex[0] ** 2 + ex[1] ** 2 + etx[0] ** 2 + etx[1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _unit(t: torch.Tensor) -> torch.Tensor:
    return t / (torch.sqrt(t[..., 0] ** 2 + t[..., 1] ** 2 + t[..., 2] ** 2) + 1e-12)[..., None]


def _refine_pose_sampson(R0, t0, x1, x2, w, iters: int = 10):
    """Gauss-Newton on (angle-axis, t) minimizing the weighted Sampson
    distance, for a batch of pairs: R0 (P, 3, 3), t0 (P, 3), x (P, M, 2),
    w (P, M). t is renormalized each step; a pair keeps a step only if it
    lowers that pair's cost. (The reference's lax.scan is this host loop.)

    The pairs are independent, so one shared 6-vector perturbation of every
    pair's parameters gives each pair's own (M, 6) Jacobian in one jacfwd."""
    params = torch.cat([log_so3(R0), t0], dim=-1)

    def resid(p):
        E = essential_from_pose(exp_so3(p[..., :3]), _unit(p[..., 3:]))
        return torch.sqrt(sampson_distance(E, x1, x2) + 1e-18) * w

    zero = torch.zeros(6, dtype=x1.dtype, device=x1.device)
    eye = 1e-8 * torch.eye(6, dtype=x1.dtype, device=x1.device)
    for _ in range(iters):
        r = resid(params)
        Jt = jacfwd(lambda d: resid(params + d))(zero).transpose(-1, -2)  # (P, 6, M)
        H = fixed_sum(Jt[..., :, None, :] * Jt[..., None, :, :]) + eye
        g = fixed_sum(Jt * r[..., None, :])
        delta = torch.linalg.solve_ex(H, g)[0]
        new = params - delta
        better = fixed_sum(resid(new) ** 2) < fixed_sum(r**2)
        params = torch.where(better[..., None], new, params)
    return exp_so3(params[..., :3]), _unit(params[..., 3:])


def _det3(A: torch.Tensor) -> torch.Tensor:
    return (
        A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
        - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
        + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
    )


def decompose_essential(E: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Four candidate (R, t): E (..., 3, 3) -> Rs (..., 4, 3, 3), ts (..., 4, 3)."""
    U, _, Vh = linalg_in_slices(torch.linalg.svd, E)
    U = U * torch.sign(_det3(U))[..., None, None]
    Vh = Vh * torch.sign(_det3(Vh))[..., None, None]
    W = torch.tensor(
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
        dtype=E.dtype, device=E.device,
    )
    Ra = matmul3(matmul3(U, W.expand(U.shape)), Vh)
    Rb = matmul3(matmul3(U, W.T.expand(U.shape)), Vh)
    t = U[..., :, 2]
    return torch.stack([Ra, Ra, Rb, Rb], dim=-3), torch.stack([t, -t, t, -t], dim=-2)


def _cheirality_counts(Rs, ts, x1, x2, mask):
    """Per candidate pose (..., 4): (near-in-front count, in-front count).
    Rs (..., 4, 3, 3), ts (..., 4, 3), x (..., M, 2), mask (..., M), the
    leading dims of x and mask broadcasting against those of Rs. The near
    gate (|z| < 50) only breaks ties (see the reference's note)."""
    eye = torch.eye(3, dtype=x1.dtype, device=x1.device)
    P1 = pose_matrix(eye, torch.zeros(3, dtype=x1.dtype, device=x1.device))
    P2 = pose_matrix(Rs, ts)
    X = triangulate_dlt(P1.expand(P2.shape), P2, x1[..., None, :, :], x2[..., None, :, :])
    z1 = X[..., 2]  # (..., 4, M)
    R2 = Rs[..., None, 2, :]
    z2 = X[..., 0] * R2[..., 0] + X[..., 1] * R2[..., 1] + X[..., 2] * R2[..., 2] + ts[..., 2:3]
    front = (z1 > 0) & (z2 > 0) & mask[..., None, :]
    near = torch.abs(z1) < 50.0
    return torch.sum(front & near, dim=-1), torch.sum(front, dim=-1)


def rotation_angle_between(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Geodesic angle (radians) between rotations (batched)."""
    c = (fixed_sum((Ra * Rb).flatten(-2)) - 1.0) * 0.5  # trace(Ra Rb^T)
    return torch.arccos(torch.clamp(c, -1.0, 1.0))


# Basin separation (radians): rotations further apart than ~2 degrees are
# distinct interpretations of the epipolar geometry.
_BASIN_SEP = 0.035


def _eval_candidates(E, bands, x1, x2, M1):
    """Cheirality treatment of candidate models E (P, T, 3, 3) with their
    consensus bands (P, T, M): the best of each model's 4 decompositions by
    (front, near), ties to the lower. Returns (rank, front, R, t), each with
    leading (P, T)."""
    Rs, ts = decompose_essential(E)
    near, front = _cheirality_counts(Rs, ts, x1[:, None], x2[:, None], bands)
    rank = front * M1 + near
    b = torch.argmax(rank, dim=-1)
    return pick(rank, b), pick(front, b), pick(Rs, b), pick(ts, b)


def _polish_eager(R0, t0, band0, x1, x2, valid, refit_n2):
    """Two rounds of Sampson refinement, each re-collecting the band."""
    R, t, band = R0, t0, band0
    for _ in range(2):
        R, t = _refine_pose_sampson(R, t, x1, x2, band.to(x1.dtype))
        band = (sampson_distance(essential_from_pose(R, t), x1, x2) < refit_n2) & valid
    return R, t, band


# The polish's shapes of this process, (P, M, dtype, device index), the most
# recently used last: a captured graph, or None for a shape seen once. Each
# graph holds a private memory pool, so only the last few shapes are kept.
_POLISH_GRAPHS: "OrderedDict[tuple, Optional[CapturedChain]]" = OrderedDict()
_POLISH_GRAPHS_KEPT = 4


def _polish_graph(key, make):
    """The graph kept for `key`: None at the key's first use, `make()` at its
    second, the same graph after (`utils/cuda_graphs.py cached_graph`, the
    last `_POLISH_GRAPHS_KEPT` keys kept)."""
    return cached_graph(_POLISH_GRAPHS, _POLISH_GRAPHS_KEPT, key, make)


def _polish(R0, t0, band0, x1, x2, valid, refit_n2):
    """Two rounds of Sampson refinement, each re-collecting the band. On the
    card the rounds are some 14,000 small ops whose host dispatch is their
    whole cost, so from a shape's second call on they replay as one CUDA
    graph; a shape's first call, and every call on the CPU, runs eagerly."""
    args = (R0, t0, band0, x1, x2, valid, refit_n2)
    if x1.device.type != "cuda":
        return _polish_eager(*args)
    with torch.cuda.device(x1.device):
        # `_polish_eager` as a graph: the six tensors copied in, refit_n2 (a
        # Python float or a 0-dim tensor) filled into a 0-dim buffer.
        graph = _polish_graph(
            (*x1.shape[:2], x1.dtype, x1.device.index),
            lambda: CapturedChain(
                _polish_eager, args[:6], (x1.dtype,), "polish_graph_captures", "polish_graph_replays"
            ),
        )
        return _polish_eager(*args) if graph is None else graph(args[:6], args[6:])


def _best_polished(R, t, band, x1, x2, M1):
    """Cheirality-best decomposition of a polished pose and whether its
    in-front fraction of the band is healthy: (R, t, front, healthy)."""
    Rs, ts = decompose_essential(essential_from_pose(R, t))
    near, front = _cheirality_counts(Rs, ts, x1, x2, band)
    best = torch.argmax(front * M1 + near, dim=-1)
    front = pick(front, best)
    healthy = front >= torch.div(torch.sum(band, dim=-1) + 1, 2, rounding_mode="floor")
    return pick(Rs, best), pick(ts, best), front, healthy


def _pose_search(x1, x2, valid, refit_n2, idx):
    """Shared RANSAC head for a batch of pairs, x (P, M, 2), valid (P, M):
    8-point hypotheses from the (P, H, 8) draws `idx`, MSAC scores,
    cheirality-ranked winner among each pair's top 8, and the Sampson polish
    kept only when its in-front fraction is healthy."""
    models = _fit_essential_dlt(
        gather_rows(x1, idx), gather_rows(x2, idx),
        torch.ones(idx.shape, dtype=x1.dtype, device=x1.device),
    )  # (P, H, 3, 3)
    res = sampson_distance(models, x1[:, None], x2[:, None])
    res = torch.where(valid[:, None, :], res, torch.zeros_like(res))
    scores = fixed_sum(torch.clamp(res, max=refit_n2))
    top = top_k_indices(-scores, 8)
    M1 = x1.shape[-2] + 1  # lexicographic rank base: front count dominates
    bands_t = (take(res, top) < refit_n2) & valid[:, None, :]
    ranks, fronts, Rs_c, ts_c = _eval_candidates(take(models, top), bands_t, x1, x2, M1)
    p = torch.argmax(ranks, dim=-1)
    R0, t0, band0, front0 = pick(Rs_c, p), pick(ts_c, p), pick(bands_t, p), pick(fronts, p)

    R, t, band = _polish(R0, t0, band0, x1, x2, valid, refit_n2)
    R2, t2, front2, use_refined = _best_polished(R, t, band, x1, x2, M1)
    return dict(
        models=models, scores=scores, res=res, M1=M1,
        R0=R0, t0=t0, band0=band0, front0=front0,
        R=_where(use_refined, R2, R0),
        t=_where(use_refined, t2, t0),
        band=_where(use_refined, band, band0),
        front=torch.where(use_refined, front2, front0),
    )


def _finish(R, t, band, front, min_points) -> RelativePose:
    n_in = torch.sum(band, dim=-1)
    det_ok = torch.abs(torch.abs(_det3(R)) - 1.0) < 1e-4
    ok = det_ok & (n_in >= min_points) & (front >= torch.div(n_in, 2, rounding_mode="floor"))
    return RelativePose(
        R=R, t=t, E=essential_from_pose(R, t), inliers=band, n_inliers=n_in, ok=ok
    )


def _as_batch(key, x1, x2, valid, samples):
    """One pair's (M, ...) inputs as a batch of one; a batch as it is."""
    if valid.dim() == 2:
        return key, x1, x2, valid, samples, False
    one = lambda a: None if a is None else a[None]  # noqa: E731
    return one(key), x1[None], x2[None], valid[None], one(samples), True


def estimate_relative_pose(
    key: Optional[torch.Tensor],
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
    x1, x2: (M, 2) normalized coords, valid (M,) and key (2,) for one pair,
    or (P, M, 2), (P, M) and (P, 2) for P pairs at once; `samples` injects
    the (H, 8) or (P, H, 8) draws in place of the key's. A batch's fields
    gain the leading P."""
    key, x1, x2, valid, samples, single = _as_batch(key, x1, x2, valid, samples)
    refit_n2 = (2.5 * threshold_px / focal) ** 2
    idx = samples if samples is not None else sample_indices(key, valid, n_hypotheses, 8)
    s = _pose_search(x1, x2, valid, refit_n2, idx)
    pose = _finish(s["R"], s["t"], s["band"], s["front"], min_points)
    return RelativePose(*(f[0] for f in pose)) if single else pose


def estimate_relative_pose_basins(
    key: Optional[torch.Tensor],
    x1: torch.Tensor,
    x2: torch.Tensor,
    valid: torch.Tensor,
    focal: float | torch.Tensor,
    threshold_px: float = 1.0,
    n_hypotheses: int = 512,
    min_points: int = 8,
    samples: Optional[torch.Tensor] = None,
) -> RelativePose:
    """Two basin-diverse pose candidates stacked on a (2, ...) axis (after
    the leading P of a batch, as in `estimate_relative_pose`): candidate 0
    is `estimate_relative_pose`'s answer; candidate 1 the best pose whose
    rotation lies > ~2 deg away (the unpolished winner if the polish jumped
    basins, else the best-MSAC alternative of the pool, polished with a
    basin guard). Third-view registration disambiguates."""
    key, x1, x2, valid, samples, single = _as_batch(key, x1, x2, valid, samples)
    refit_n2 = (2.5 * threshold_px / focal) ** 2
    idx = samples if samples is not None else sample_indices(key, valid, n_hypotheses, 8)
    s = _pose_search(x1, x2, valid, refit_n2, idx)
    R_a, t_a = s["R"], s["t"]
    models, scores, res = s["models"], s["scores"], s["res"]

    jumped = rotation_angle_between(R_a, s["R0"]) > _BASIN_SEP
    Rs_m, _ = decompose_essential(models)
    R_ref = R_a[:, None]
    dists = torch.minimum(
        rotation_angle_between(Rs_m[..., 0, :, :], R_ref),
        rotation_angle_between(Rs_m[..., 2, :, :], R_ref),
    )
    alt_scores = torch.where(dists > _BASIN_SEP, scores, torch.full_like(scores, math.inf))
    alt_top = top_k_indices(-alt_scores, 8)
    bands_alt = (take(res, alt_top) < refit_n2) & valid[:, None, :]
    ranks_alt, fronts_alt, Rs_alt, ts_alt = _eval_candidates(
        take(models, alt_top), bands_alt, x1, x2, s["M1"]
    )
    ranks_alt = torch.where(
        torch.isfinite(take(alt_scores, alt_top)), ranks_alt, torch.full_like(ranks_alt, -1)
    )
    p = torch.argmax(ranks_alt, dim=-1)
    has_alt = pick(ranks_alt, p) >= 0

    R_b0 = _where(jumped, s["R0"], pick(Rs_alt, p))
    t_b0 = _where(jumped, s["t0"], pick(ts_alt, p))
    band_b0 = _where(jumped, s["band0"], pick(bands_alt, p))
    front_b0 = torch.where(jumped, s["front0"], pick(fronts_alt, p))
    usable_b = jumped | has_alt

    R_b, t_b, band_b = _polish(R_b0, t_b0, band_b0, x1, x2, valid, refit_n2)
    stayed = rotation_angle_between(R_b, R_a) > _BASIN_SEP
    R_b2, t_b2, front_b2, healthy = _best_polished(R_b, t_b, band_b, x1, x2, s["M1"])
    keep_pol = stayed & healthy
    R_b = _where(keep_pol, R_b2, R_b0)
    t_b = _where(keep_pol, t_b2, t_b0)
    band_b = _where(keep_pol, band_b, band_b0)
    front_b = torch.where(keep_pol, front_b2, front_b0)

    cand_a = _finish(R_a, t_a, s["band"], s["front"], min_points)
    cand_b = _finish(R_b, t_b, band_b, front_b, min_points)
    cand_b = cand_b._replace(ok=cand_b.ok & usable_b)
    both = RelativePose(*(torch.stack([a, b], dim=1) for a, b in zip(cand_a, cand_b)))
    return RelativePose(*(f[0] for f in both)) if single else both
