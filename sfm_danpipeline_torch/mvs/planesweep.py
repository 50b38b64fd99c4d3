"""Plane-sweep depth estimation with a ZNCC photometric cost.

Port of sfm_danpipeline_tpu/mvs/planesweep.py (the PMVS2 replacement:
level 1, 7x7 windows, threshold 0.7). For every fronto-parallel depth
hypothesis the source image is homography-warped into the reference view
and windowed ZNCC against the reference picks the best plane per pixel.
This is the `method="sweep"` branch of `densify` and the oracle that the
rectified sweep (mvs/rectsweep.py) is held against.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from sfm_danpipeline_torch.ops.interp import bilinear_sample


class DepthMap(NamedTuple):
    depth: torch.Tensor  # (H, W) float32, 0 where invalid
    score: torch.Tensor  # (H, W) best ZNCC in [-1, 1]


def _window_mean(x: torch.Tensor, w: int) -> torch.Tensor:
    """Mean over a w x w window with SAME padding, divided by the number of
    in-bounds pixels. x: (..., H, W)."""
    lo, hi = (w - 1) // 2, w // 2
    shape = x.shape
    x4 = x.reshape((-1, 1) + shape[-2:])

    def box_sum(a):
        return F.avg_pool2d(F.pad(a, (lo, hi, lo, hi)), w, stride=1, divisor_override=1)

    return (box_sum(x4) / box_sum(torch.ones_like(x4[:1]))).reshape(shape)


def plane_homography(
    K: torch.Tensor, R_rs: torch.Tensor, t_rs: torch.Tensor, depth
) -> torch.Tensor:
    """Homography from reference to source pixels for the plane z = depth
    in the reference frame (x_s = R_rs x_r + t_rs):
    H = K (R + t n^T / d) K^-1 with n = (0, 0, 1). A depth tensor of shape
    (D, 1, 1) gives D homographies."""
    n = torch.tensor([0.0, 0.0, 1.0], dtype=K.dtype, device=K.device)
    return K @ (R_rs + torch.outer(t_rs, n) / depth) @ torch.linalg.inv(K)


def _pixel_grid(H: int, W: int, device) -> tuple:
    ys, xs = torch.meshgrid(
        torch.arange(H, device=device), torch.arange(W, device=device), indexing="ij"
    )
    return ys, xs


def _apply_homography(M: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """Map pixel grids through M (..., 3, 3); returns (u, v) of shape
    (...,) + grid shape."""
    M = M[..., None, None]
    xh = M[..., 0, 0, :, :] * xs + M[..., 0, 1, :, :] * ys + M[..., 0, 2, :, :]
    yh = M[..., 1, 0, :, :] * xs + M[..., 1, 1, :, :] * ys + M[..., 1, 2, :, :]
    wh = M[..., 2, 0, :, :] * xs + M[..., 2, 1, :, :] * ys + M[..., 2, 2, :, :]
    wh = torch.where(torch.abs(wh) < 1e-9, torch.full_like(wh, 1e-9), wh)
    return xh / wh, yh / wh


def _sweep_one_source(
    ref: torch.Tensor, src: torch.Tensor, K: torch.Tensor, R_rs: torch.Tensor,
    t_rs: torch.Tensor, depths: torch.Tensor, window: int = 7,
) -> torch.Tensor:
    """ZNCC cost volume (D, H, W) of one source view against the reference."""
    H, W = ref.shape
    ys, xs = _pixel_grid(H, W, ref.device)
    ref_mean = _window_mean(ref, window)
    ref_zm = ref - ref_mean
    ref_var = _window_mean(ref_zm * ref_zm, window)
    Hm = plane_homography(K, R_rs, t_rs, depths[:, None, None])
    u, v = _apply_homography(Hm, xs, ys)  # (D, H, W)
    inside = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    warped = bilinear_sample(src, u, v)
    w_zm = warped - _window_mean(warped, window)
    w_var = _window_mean(w_zm * w_zm, window)
    cov = _window_mean(ref_zm * w_zm, window)
    zncc = cov / torch.sqrt(torch.clamp(ref_var * w_var, min=1e-10))
    return torch.where(inside, zncc, torch.full_like(zncc, -1.0))


def _parabolic(cost: torch.Tensor, inv: torch.Tensor):
    """Argmax over the first axis with parabolic sub-plane refinement in
    inverse depth. Returns (refined inverse depth, best score)."""
    D = cost.shape[0]
    best = torch.argmax(cost, dim=0)
    score = torch.max(cost, dim=0).values
    cp = torch.gather(cost, 0, torch.clamp(best + 1, 0, D - 1)[None])[0]
    cm = torch.gather(cost, 0, torch.clamp(best - 1, 0, D - 1)[None])[0]
    denom = cm - 2 * score + cp
    ok = torch.abs(denom) > 1e-9
    delta = 0.5 * (cm - cp) / torch.where(ok, denom, torch.ones_like(denom))
    delta = torch.clamp(torch.where(ok, delta, torch.zeros_like(delta)), -0.5, 0.5)
    inv_step = (inv[-1] - inv[0]) / max(D - 1, 1)
    return inv[best] + delta * inv_step, score


def sweep_depth_map(
    ref: torch.Tensor,  # (H, W) reference gray
    srcs: torch.Tensor,  # (S, H, W) source grays
    K: torch.Tensor,
    R_rs: torch.Tensor,  # (S, 3, 3) source-from-reference rotations
    t_rs: torch.Tensor,  # (S, 3)
    src_valid: torch.Tensor,  # (S,) source usable
    depths: torch.Tensor,  # (D,) hypothesis depths (reference frame)
    min_score: float = 0.7,
    window: int = 7,
) -> DepthMap:
    """Multi-source plane sweep: per-pixel mean ZNCC over the usable
    sources, argmax over the hypotheses, PMVS2's photometric threshold."""
    cost_sum = torch.zeros((depths.shape[0],) + ref.shape, dtype=ref.dtype, device=ref.device)
    n = torch.zeros((), dtype=ref.dtype, device=ref.device)
    for s in range(srcs.shape[0]):
        vol = _sweep_one_source(ref, srcs[s], K, R_rs[s], t_rs[s], depths, window)
        usable = src_valid[s].to(ref.dtype)
        cost_sum = cost_sum + vol * usable
        n = n + usable
    cost = cost_sum / torch.clamp(n, min=1.0)
    inv_ref, score = _parabolic(cost, 1.0 / depths)
    depth = 1.0 / torch.clamp(inv_ref, min=1e-9)
    ok = score >= min_score
    return DepthMap(
        depth=torch.where(ok, depth, torch.zeros_like(depth)),
        score=torch.where(ok, score, torch.full_like(score, -1.0)),
    )


def make_depth_hypotheses(
    z_samples: torch.Tensor, n_planes: int, pad: float = 0.25
) -> torch.Tensor:
    """Inverse-depth-uniform hypotheses covering the 5-95 percentile range
    of the sparse depths in the reference camera (entries <= 0 ignored),
    padded by `pad`, in increasing depth."""
    z = torch.where(z_samples > 0, z_samples, torch.full_like(z_samples, float("nan")))
    q = torch.nanquantile(z, torch.tensor([0.05, 0.95], dtype=z.dtype, device=z.device))
    lo = torch.nan_to_num(q[0], nan=1.0) * (1.0 - pad)
    hi = torch.nan_to_num(q[1], nan=10.0) * (1.0 + pad)
    lo = torch.clamp(lo, min=1e-3)
    inv = torch.linspace(float(1.0 / hi), float(1.0 / lo), n_planes, device=z.device)
    return 1.0 / torch.flip(inv, [0])
