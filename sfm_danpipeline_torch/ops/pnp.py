"""PnP pose estimation: DLT-PnP and P3P RANSAC + Gauss-Newton refinement.

Port of sfm_danpipeline_tpu/ops/pnp.py (the reference's solvePnPRansac +
plausibility guards, src/Sfm.cpp:1137-1210): a pool of 6-point DLT and
3-point P3P (multi-start Newton) hypotheses, two-stage MSAC selection, an
8 px second-chance recount, two Gauss-Newton refinements, and the
tight-consensus acceptance gate. Hypothesis batches are leading dims.

On the card a solve is some 11,000 small ops whose host dispatch is their
whole cost. It runs as draws -> DLT fit -> P3P Newton loop -> P3P
Procrustes SVD -> select-refine-accept. The Newton loop (`_p3p_newton`) and
select-refine-accept (`_select_refine_accept`, from the models to the
acceptance gate) read nothing back to the host, so they replay as one CUDA
graph each (~9,700 of the ops). The draws stay eager because the key lives
on the host and `prng.fold_bits` reads back; the DLT fit and the Procrustes
step stay eager because `torch.linalg.eigh` and `torch.linalg.svd` check
their `info` on the host, which a capture refuses. A process's first solve
runs eagerly (the warm-up: jacfwd's first call, the cuBLAS and cuSOLVER
handles); after it every shape captures at its first call and replays after
(`utils/cuda_graphs.py`). On the CPU every solve runs eagerly.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd

from sfm_danpipeline_torch.ops import prng
from sfm_danpipeline_torch.ops.epipolar import _det3
from sfm_danpipeline_torch.ops.lie import exp_so3, log_so3, rotate_point
from sfm_danpipeline_torch.ops.ransac import sample_indices
from sfm_danpipeline_torch.ops.select import top_k_indices
from sfm_danpipeline_torch.utils.cuda_graphs import CapturedChain


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


# The starts on each device, made once outside any capture: made inside the
# Newton loop they would be a host-to-device copy, which a capture refuses.
_P3P_STARTS_ON: Dict[torch.device, torch.Tensor] = {}


def _p3p_starts(device: torch.device) -> torch.Tensor:
    starts = _P3P_STARTS_ON.get(device)
    if starts is None:
        starts = _P3P_STARTS_ON[device] = torch.as_tensor(_P3P_STARTS, device=device)
    return starts


def _p3p_newton(X3: torch.Tensor, y3: torch.Tensor, starts: torch.Tensor):
    """Minimal 3-point pose, batched, up to its SVD: X3 (H, 3, 3) world
    points, y3 (H, 3, 3) unit bearings. Damped Newton on the depth-ratio
    system from each of the 7 `starts`, the residual gate, and each
    candidate's Procrustes problem. Returns ok (H, 7), the world and camera
    centroids cw, cc (H, 7, 3) and the cross-covariance C (H, 7, 3, 3);
    `_p3p_procrustes` turns them into (H, 7, 3, 4) poses."""
    d12 = torch.sum((X3[:, 0] - X3[:, 1]) ** 2, -1)[:, None]
    d13 = torch.sum((X3[:, 0] - X3[:, 2]) ** 2, -1)[:, None]
    d23 = torch.sum((X3[:, 1] - X3[:, 2]) ** 2, -1)[:, None]
    c12 = torch.sum(y3[:, 0] * y3[:, 1], -1)[:, None]
    c13 = torch.sum(y3[:, 0] * y3[:, 2], -1)[:, None]
    c23 = torch.sum(y3[:, 1] * y3[:, 2], -1)[:, None]
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
    return ok, cw, cc, C


def _p3p_procrustes(ok, cw, cc, C) -> torch.Tensor:
    """The tail of the minimal 3-point pose: each candidate's rotation from
    the SVD of its cross-covariance; a failed start returns a sentinel pose
    at translation 1e12 that scoring discards."""
    U, _, Vh = torch.linalg.svd(C)
    sgn = torch.sign(torch.linalg.det(U @ Vh))
    diag = torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], dim=-1)
    R = (U * diag[..., None, :]) @ Vh
    t = cc - (R @ cw[..., None])[..., 0]
    eye = torch.eye(3, dtype=cw.dtype, device=cw.device)
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


def _select_refine_accept(models, X, px, valid, score_w, order, K, threshold_px,
                          min_support: int, max_translation: float):
    """Everything after the models are built: the two-stage MSAC pick (every
    hypothesis prescored on the rows `order`, the best 384 full-scored),
    the 8 px second chance, both Gauss-Newton refinements and the acceptance
    gate. Returns (R, t, inliers, n_inliers, ok). Every index is a gather at
    a device index, so the chain reads nothing back to the host."""
    # Two-stage MSAC: prescore every hypothesis on the prescore rows,
    # full-score the top 384; strict rows weigh double.
    sub_valid = valid[order]
    pres = torch.clamp(_reproj_errors_px(models, X[order], px[order], K), max=1e9)
    pres = torch.where(sub_valid[None, :], pres, torch.zeros_like(pres))
    pre_scores = torch.sum(score_w[order][None, :] * torch.clamp(pres, max=threshold_px), dim=-1)
    T = min(384, models.shape[0])
    top = top_k_indices(-pre_scores, T)
    res = torch.clamp(_reproj_errors_px(models[top], X, px, K), max=1e9)
    res = torch.where(valid[None, :], res, torch.zeros_like(res))
    scores = torch.sum(score_w[None, :] * torch.clamp(res, max=threshold_px), dim=-1)
    best = torch.argmin(scores).reshape(1)
    Rt = models.index_select(0, top.index_select(0, best))[0]
    inliers = (res.index_select(0, best)[0] < threshold_px) & valid
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
        (torch.abs(_det3(R) - 1.0) < 1e-3)
        & (torch.linalg.norm(center) <= max_translation)
        & (n_in >= min_support)
    )
    return R, t, inliers, n_in, ok


# The process's PnP graphs, kept for the process: `_NEWTON_GRAPHS` keyed by
# (H_p3p, dtypes, device index), one per process; `_SELECT_GRAPHS` by (M, H,
# S, dtypes, device index, the gate's two constants), one per done-view count
# the sets reach. They draw on one memory pool per device (`_POOLS`), so a
# graph costs little more than its static inputs and outputs, and since none
# is freed the pool lives as long as the process.
_NEWTON_GRAPHS: Dict[tuple, CapturedChain] = {}
_SELECT_GRAPHS: Dict[tuple, CapturedChain] = {}
_POOLS: Dict[int, tuple] = {}
# The devices on which this process has run a solve eagerly: from then on a
# shape captures at its first call.
_WARM: set = set()


def _run_chains(models6, p3p_in, select_in, gate, newton=None, select=None):
    """The solve after the draws and the DLT fit: the P3P Newton loop
    (replayed by `newton` where given), the Procrustes SVD (eager), then
    select-refine-accept (replayed by `select` where given)."""
    head = _p3p_newton(*p3p_in, _p3p_starts(p3p_in[0].device)) if newton is None else newton(p3p_in)
    models = torch.cat([models6, _p3p_procrustes(*head).reshape(-1, 3, 4)])
    tensors, threshold_px = (models, *select_in[:-1]), select_in[-1]
    if select is None:
        return _select_refine_accept(*tensors, threshold_px, *gate)
    return select(tensors, (threshold_px,))


def _replay_chains(models6, p3p_in, select_in, gate):
    """`_run_chains` on the card: the process's first solve eagerly, after it
    each chain replayed from its graph, captured at the shape's first call
    (`utils/cuda_graphs.py`)."""
    dev = p3p_in[0].device
    if dev.index not in _WARM:
        out = _run_chains(models6, p3p_in, select_in, gate)
        _WARM.add(dev.index)
        return out
    if dev.index not in _POOLS:
        _POOLS[dev.index] = torch.cuda.graph_pool_handle()
    pool = _POOLS[dev.index]
    newton_key = (p3p_in[0].shape[0], *(a.dtype for a in p3p_in), dev.index)
    if newton_key not in _NEWTON_GRAPHS:
        starts = _p3p_starts(dev)
        _NEWTON_GRAPHS[newton_key] = CapturedChain(
            lambda X3, y3: _p3p_newton(X3, y3, starts), p3p_in, (), "pnp_graph_captures", pool=pool,
        )
    X = select_in[0]
    models_shape = (models6.shape[0] + 7 * p3p_in[0].shape[0], 3, 4)
    select_key = (
        X.shape[0], models_shape[0], select_in[4].shape[0],
        models6.dtype, *(a.dtype for a in select_in[:-1]), dev.index, *gate,
    )
    if select_key not in _SELECT_GRAPHS:
        _SELECT_GRAPHS[select_key] = CapturedChain(
            lambda *a: _select_refine_accept(*a, *gate),
            (models6.new_empty(models_shape), *select_in[:-1]), (X.dtype,),
            "pnp_graph_captures", "pnp_graph_replays", pool,
        )
    return _run_chains(
        models6, p3p_in, select_in, gate, _NEWTON_GRAPHS[newton_key], _SELECT_GRAPHS[select_key]
    )


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
    no true row, so every hypothesis the prescore keeps is wrong.

    On the card the Newton loop and select-refine-accept replay as CUDA
    graphs (module docstring)."""
    idx6, idx3 = samples if samples is not None else pnp_sample_draws(
        key, valid, n_hypotheses, sample_size, sample_mask
    )
    models6 = _dlt_pnp(X[idx6], xn[idx6])
    h = torch.cat([xn, torch.ones_like(xn[:, :1])], dim=-1)
    y = h / torch.linalg.norm(h, dim=-1, keepdim=True)

    score_w = (
        1.0 + (sample_mask & valid).to(X.dtype) if sample_mask is not None
        else torch.ones_like(valid, dtype=X.dtype)
    )
    S = min(PRESCORE_ROWS, X.shape[0])
    rank = (~valid).to(torch.int8)
    if prescore_strict_first and sample_mask is not None:
        rank = rank * 2 + (~sample_mask).to(torch.int8)
    order = torch.argsort(rank, stable=True)[:S]

    p3p_in = (X[idx3], y[idx3])
    select_in = (X, px, valid, score_w, order, K, threshold_px)
    gate = (max(sample_size, min_inliers), max_translation)
    if X.device.type != "cuda":
        out = _run_chains(models6, p3p_in, select_in, gate)
    else:
        with torch.cuda.device(X.device):
            out = _replay_chains(models6, p3p_in, select_in, gate)
    return PnPResult(*out)
