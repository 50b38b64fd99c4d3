"""Rectified plane sweep: the dense-depth estimator of the default path.

Port of sfm_danpipeline_tpu/mvs/rectsweep.py. Both cameras of a
(reference, source) pair are rotated about their centers so that the
baseline becomes the shared x-axis (Fusiello's method, pure rotation
homographies). In the rectified frames a fronto-parallel plane at
rectified depth z projects with a constant disparity d = f B / z, so the
depth sweep becomes D horizontally shifted ZNCC evaluations. Here the D
shifts are one batched gather with border masks and the whole (D, H, W)
cost volume is evaluated at once. Each source's estimate is transported
back to the reference frame; the sources combine by a score-gated median
plus an agreement count.
"""
from __future__ import annotations

import torch

from sfm_danpipeline_torch.mvs.planesweep import (
    DepthMap,
    _apply_homography,
    _parabolic,
    _pixel_grid,
    _window_mean,
)
from sfm_danpipeline_torch.ops.interp import bilinear_sample


def rectifying_rotation(C: torch.Tensor) -> torch.Tensor:
    """Rotation R_rect (rect-from-ref) for a source with center C in the
    reference camera frame: new x = baseline direction, new z as close to
    the old optical axis as orthogonality allows."""
    e1 = C / (torch.linalg.norm(C) + 1e-12)
    z_old = torch.tensor([0.0, 0.0, 1.0], dtype=C.dtype, device=C.device)
    e2 = torch.linalg.cross(z_old, e1)
    n2 = torch.linalg.norm(e2)
    # Baseline ~parallel to the optical axis: rectification degenerates;
    # the caller masks such sources.
    e2 = torch.where(
        n2 > 1e-6, e2 / (n2 + 1e-12),
        torch.tensor([0.0, 1.0, 0.0], dtype=C.dtype, device=C.device),
    )
    e3 = torch.linalg.cross(e1, e2)
    return torch.stack([e1, e2, e3])


def _rotation_warp(img: torch.Tensor, K: torch.Tensor, R: torch.Tensor):
    """Sample `img` so that output pixel p shows the scene along the ray
    R^T K^-1 p (the pure-rotation homography K R^T K^-1, read backwards).
    Returns (warped, inside_mask)."""
    H, W = img.shape
    ys, xs = _pixel_grid(H, W, img.device)
    u, v = _apply_homography(K @ R.T @ torch.linalg.inv(K), xs, ys)
    inside = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    return bilinear_sample(img, u, v), inside


def _shift_x(img: torch.Tensor, disps: torch.Tensor):
    """img (H, W) sampled at (x - d) along rows for every disparity d of
    disps (D,), fractional, zero outside. Returns ((D, H, W) shifted
    images, (D, 1, W) mask of columns whose two integer taps are inside)."""
    W = img.shape[-1]
    d0 = torch.floor(disps).long()
    frac = (disps - d0.to(disps.dtype))[:, None, None]
    xs = torch.arange(W, device=img.device)

    def taps(d):
        src = xs[None, :] - d[:, None]  # (D, W)
        ok = (src >= 0) & (src < W)
        vals = img[:, torch.clamp(src, 0, W - 1)].permute(1, 0, 2)  # (D, H, W)
        return torch.where(ok[:, None, :], vals, torch.zeros_like(vals)), ok[:, None, :]

    a, ok_a = taps(d0)
    b, ok_b = taps(d0 + 1)
    return (1.0 - frac) * a + frac * b, ok_a & ok_b


def rect_sweep_pair(
    ref: torch.Tensor,  # (H, W) reference gray
    src: torch.Tensor,  # (H, W) source gray
    K: torch.Tensor,
    R_rs: torch.Tensor,  # source-from-reference rotation
    t_rs: torch.Tensor,
    z_lo,
    z_hi,
    n_depths: int = 128,
    window: int = 7,
):
    """Depth from one (ref, src) pair by the rectified sweep. Returns
    (depth (H, W) in the reference frame, zncc score (H, W))."""
    C = -R_rs.T @ t_rs  # source center in the reference frame
    B = torch.linalg.norm(C) + 1e-12
    R_rect = rectifying_rotation(C)
    rref, in_r = _rotation_warp(ref, K, R_rect)
    rsrc, in_s = _rotation_warp(src, K, R_rect @ R_rs.T)

    inv = torch.linspace(float(1.0 / z_hi), float(1.0 / z_lo), n_depths, device=ref.device)
    disps = K[0, 0] * B * inv  # (D,) constant disparity per rectified depth

    ref_zm = rref - _window_mean(rref, window)
    ref_var = _window_mean(ref_zm * ref_zm, window)
    s, ok = _shift_x(rsrc, disps)
    # The source inside-mask shifts with the image: bilinear sampling
    # clamps at the border, so without it ZNCC near the rectification
    # border would correlate against edge-replicated content.
    ins, _ = _shift_x(in_s.to(rsrc.dtype), disps)
    s_zm = s - _window_mean(s, window)
    s_var = _window_mean(s_zm * s_zm, window)
    cov = _window_mean(ref_zm * s_zm, window)
    zncc = cov / torch.sqrt(torch.clamp(ref_var * s_var, min=1e-10))
    cost = torch.where(ok & in_r & (ins > 0.99), zncc, torch.full_like(zncc, -1.0))
    inv_best, score = _parabolic(cost, inv)
    z_rect = 1.0 / torch.clamp(inv_best, min=1e-9)

    # Transport back to the reference frame: reference pixel q looks along
    # K^-1 q, its rectified pixel is K R_rect K^-1 q, and the 3D point
    # z_rect * K^-1 p_rect (rectified coords) has reference-frame depth
    # z_rect * (R_rect^T [dirx, diry, 1])_z.
    H, W = ref.shape
    ys, xs = _pixel_grid(H, W, ref.device)
    u, v = _apply_homography(K @ R_rect @ torch.linalg.inv(K), xs, ys)
    inside = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    z_r = bilinear_sample(z_rect, u, v)
    s_r = bilinear_sample(score, u, v)
    dirx = (u - K[0, 2]) / K[0, 0]
    diry = (v - K[1, 2]) / K[1, 1]
    z_ref = z_r * (R_rect[0, 2] * dirx + R_rect[1, 2] * diry + R_rect[2, 2])
    ok = inside & (z_ref > 0)
    return (
        torch.where(ok, z_ref, torch.zeros_like(z_ref)),
        torch.where(ok, s_r, torch.full_like(s_r, -1.0)),
    )


def nanmedian_mean_middle(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median over axis 0 of the entries where `valid`, averaging the two
    middle values for an even count (numpy's nanmedian; torch.nanmedian
    returns the lower one); 0 where no entry is valid."""
    n = torch.sum(valid, dim=0)
    srt = torch.sort(torch.where(valid, x, torch.full_like(x, float("inf"))), dim=0).values
    lo = torch.gather(srt, 0, torch.clamp((n - 1) // 2, min=0)[None])[0]
    hi = torch.gather(srt, 0, torch.clamp(n // 2, max=x.shape[0] - 1)[None])[0]
    med = torch.where(n % 2 == 0, 0.5 * (lo + hi), lo)
    return torch.where(n > 0, med, torch.zeros_like(med))


def rect_sweep_depth_map(
    ref: torch.Tensor,  # (H, W)
    srcs: torch.Tensor,  # (S, H, W)
    K: torch.Tensor,
    R_rs: torch.Tensor,  # (S, 3, 3)
    t_rs: torch.Tensor,  # (S, 3)
    src_valid: torch.Tensor,  # (S,)
    z_lo,
    z_hi,
    min_score: float = 0.7,
    n_depths: int = 128,
    window: int = 7,
    agree_frac: float = 0.03,
) -> DepthMap:
    """Multi-source rectified sweep with per-pixel source consensus: a
    pixel keeps the median depth of the sources that pass `min_score` when
    at least two of them agree within `agree_frac` of it (PMVS2's
    photometric threshold plus multi-image support); a single-source pixel
    survives only on a stricter score."""
    # Source centers nearly along the optical axis cannot rectify.
    C = -torch.einsum("sji,sj->si", R_rs, t_rs)
    e1 = C / (torch.linalg.norm(C, dim=-1, keepdim=True) + 1e-12)
    ok_geom = torch.abs(e1[:, 2]) < 0.99
    pairs = [
        rect_sweep_pair(ref, srcs[s], K, R_rs[s], t_rs[s], z_lo, z_hi, n_depths, window)
        for s in range(srcs.shape[0])
    ]
    depth_s = torch.stack([p[0] for p in pairs])  # (S, H, W)
    score_s = torch.stack([p[1] for p in pairs])
    usable = (src_valid & ok_geom)[:, None, None]
    qual = usable & (score_s >= min_score) & (depth_s > 0)

    big = 1e9
    med = nanmedian_mean_middle(depth_s, qual)
    agree = qual & (torch.abs(depth_s - med[None]) <= agree_frac * torch.clamp(med, min=1e-9))
    n_agree = torch.sum(agree, dim=0)
    agree_sum = torch.sum(torch.where(agree, score_s, torch.zeros_like(score_s)), dim=0)
    mean_score = agree_sum / torch.clamp(n_agree, min=1)
    gated = torch.where(qual, score_s, torch.full_like(score_s, -big))
    best_s = torch.max(gated, dim=0).values
    best_i = torch.argmax(gated, dim=0)  # first maximum, as jnp.argmax
    d_best = torch.gather(depth_s, 0, best_i[None])[0]
    strict = min(0.5 * (1.0 + min_score), 0.95)
    use_multi = n_agree >= 2
    use_single = (~use_multi) & (best_s >= strict)
    zero = torch.zeros_like(med)
    depth = torch.where(use_multi, med, torch.where(use_single, d_best, zero))
    score = torch.where(use_multi, mean_score, torch.where(use_single, best_s, zero - 1.0))
    return DepthMap(depth=depth, score=score)
