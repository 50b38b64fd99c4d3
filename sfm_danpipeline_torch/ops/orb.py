"""ORB-style feature detection: FAST corners + rotated BRIEF descriptors.

Port of sfm_danpipeline_tpu/ops/orb.py (the reference's detector switch,
include/Sfm.h:40-61, src/Sfm.cpp:303-392), batched over images:

 - FAST-9/16 corner test as 16 shifted whole-image comparisons and a
   contiguous-run reduction.
 - Harris corner response for ranking (ORB's HARRIS_SCORE default).
 - Image pyramid (scaleFactor 1.2, nlevels 8: OpenCV ORB defaults).
 - Orientation by intensity centroid (patch radius 15).
 - 256-bit BRIEF on a seeded Gaussian pattern, steered by the orientation.
   Bits are float32 0/1, so squared L2 in the kNN kernel equals the Hamming
   distance.

The bit pattern is the reference's own seeded one (numpy's generator, so it
is bit-equal in both packages), not OpenCV's learned table.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sfm_danpipeline_torch.ops.interp import bilinear_sample_batch
from sfm_danpipeline_torch.ops.select import top_k_indices
from sfm_danpipeline_torch.ops.sift import Keypoints, _gradient_stacks, _take, gaussian_blur

# Bresenham circle of radius 3 (the FAST-16 ring), clockwise from 12h.
_RING = [
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
]


def _fast_response(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9/16 corner mask (N, H, W): >= 9 contiguous ring pixels all
    brighter than c+t or all darker than c-t."""
    shifted = torch.stack(
        [torch.roll(img, (-dy, -dx), dims=(-2, -1)) for dx, dy in _RING]
    )  # (16, N, H, W): the ring pixel's value at each centre
    brighter = shifted > img[None] + threshold
    darker = shifted < img[None] - threshold

    def has_run9(mask):
        # Wrap-around contiguous run of >= 9: AND of 9 consecutive rotations.
        db = torch.cat([mask, mask[:8]], dim=0)  # (24, N, H, W)
        out = torch.zeros_like(mask[0])
        for s in range(16):
            out |= torch.all(db[s : s + 9], dim=0)
        return out

    return has_run9(brighter) | has_run9(darker)


def _harris_response(img: torch.Tensor, k: float = 0.04) -> torch.Tensor:
    """Harris corner measure with a 7x7 sum window (ORB's ranking score)."""
    gx, gy = _gradient_stacks(img)

    def box(x):
        return F.avg_pool2d(x[:, None], 7, stride=1, padding=3, divisor_override=1)[:, 0]

    sxx = box(gx * gx)
    syy = box(gy * gy)
    sxy = box(gx * gy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def _orientation_centroid(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, radius: int = 15
) -> torch.Tensor:
    """Intensity-centroid orientation (Rosin): atan2(m01, m10) over a
    circular patch. img (N, H, W); x, y (N, K) keypoint centres."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=img.device)
    dv, du = torch.meshgrid(d, d, indexing="ij")
    du = du.reshape(-1)
    dv = dv.reshape(-1)
    circle = (du * du + dv * dv) <= radius * radius
    vals = bilinear_sample_batch(img, x[..., None] + du, y[..., None] + dv)
    vals = torch.where(circle, vals, torch.zeros_like(vals))
    m10 = torch.sum(du * vals, dim=-1)
    m01 = torch.sum(dv * vals, dim=-1)
    return torch.atan2(m01, m10)


def _brief_pattern(n_bits: int = 256, patch: int = 31, seed: int = 7) -> np.ndarray:
    """Seeded isotropic-Gaussian point pairs (BRIEF recipe, sigma=patch/5):
    (n_bits, [x1 y1 x2 y2]) float32."""
    rng = np.random.default_rng(seed)
    sigma = patch / 5.0
    pts = rng.normal(0.0, sigma, (n_bits, 4)).clip(-(patch // 2), patch // 2)
    return pts.astype(np.float32)


_PATTERN = _brief_pattern()


def _brief_descriptors(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, angle: torch.Tensor
) -> torch.Tensor:
    """Steered BRIEF: rotate the pattern by the keypoint angle, compare
    smoothed intensities. (N, K) inputs -> (N, K, 256) float32 of {0, 1}."""
    pat = torch.as_tensor(_PATTERN, device=img.device)
    ca = torch.cos(angle)[..., None]
    sa = torch.sin(angle)[..., None]
    px1 = pat[:, 0] * ca - pat[:, 1] * sa
    py1 = pat[:, 0] * sa + pat[:, 1] * ca
    px2 = pat[:, 2] * ca - pat[:, 3] * sa
    py2 = pat[:, 2] * sa + pat[:, 3] * ca
    a = bilinear_sample_batch(img, x[..., None] + px1, y[..., None] + py1)
    b = bilinear_sample_batch(img, x[..., None] + px2, y[..., None] + py2)
    return (a < b).to(torch.float32)


def detect_and_compute_orb_batch(
    gray: torch.Tensor,
    max_keypoints: int = 2048,
    n_levels: int = 8,
    threshold: float = 0.08,
) -> Keypoints:
    """ORB keypoints + 256-d binary (0/1 float) descriptors for a batch of
    grayscale images (N, H, W) in [0, 1].

    Defaults mirror OpenCV ORB (nlevels=8, scaleFactor=1.2); `threshold` is
    FAST's intensity delta in [0, 1] units (OpenCV's 20/255 ~ 0.078).
    Descriptors match with the standard matcher (L2^2 == Hamming); use a
    ratio of ~0.9 for binary descriptors."""
    img = gray.to(torch.float32)
    N = img.shape[0]
    scale_step = 1.2
    scale = 1.0
    per_level = []
    for lvl in range(n_levels):
        h, w = img.shape[-2:]
        if min(h, w) < 48:
            break
        # Light pre-smoothing stabilizes FAST + BRIEF.
        smooth = gaussian_blur(img, 1.0)
        corners = _fast_response(smooth, threshold)
        harris = _harris_response(smooth)
        border = 20
        bmask = torch.zeros((h, w), dtype=torch.bool, device=img.device)
        bmask[border:-border, border:-border] = True
        resp = torch.where(corners & bmask, harris, torch.full_like(harris, -torch.inf))
        k_lvl = min(max(max_keypoints // (2**lvl), 64), h * w)
        # Most pixels tie at -inf: the stable order keeps the lower index
        # first among ties, as the reference's top_k does.
        flat = resp.reshape(N, -1)
        idx = top_k_indices(flat, k_lvl)
        vals = torch.gather(flat, 1, idx)
        yy = (idx // w).to(torch.float32)
        xx = (idx % w).to(torch.float32)
        valid = torch.isfinite(vals) & (vals > 0)
        ang = _orientation_centroid(smooth, xx, yy)
        desc = _brief_descriptors(smooth, xx, yy, ang)
        per_level.append(
            (
                xx * scale, yy * scale,
                torch.full_like(xx, scale * 7.0),  # nominal patch scale
                ang, torch.where(valid, vals, torch.zeros_like(vals)), desc, valid,
            )
        )
        # Downsample by 1.2: antialiased bilinear resize (what
        # jax.image.resize "bilinear" computes when shrinking).
        nh, nw = int(round(h / scale_step)), int(round(w / scale_step))
        img = F.interpolate(
            img[:, None], size=(nh, nw), mode="bilinear", align_corners=False, antialias=True
        )[:, 0]
        scale *= scale_step

    xs, ys, sig, ang, resp, desc, valid = (
        torch.cat([p[i] for p in per_level], dim=1) for i in range(7)
    )
    score = torch.where(valid, resp, torch.full_like(resp, -1.0))
    top = top_k_indices(score, max_keypoints)
    return Keypoints(
        xy=torch.stack([_take(xs, top), _take(ys, top)], dim=-1),
        sigma=_take(sig, top),
        angle=_take(ang, top),
        response=_take(resp, top),
        descriptors=_take(desc, top),
        valid=_take(valid, top) & (_take(score, top) > 0),
    )


def detect_and_compute_orb(
    gray: torch.Tensor,
    max_keypoints: int = 2048,
    n_levels: int = 8,
    threshold: float = 0.08,
) -> Keypoints:
    """ORB keypoints + descriptors for one grayscale image (H, W)."""
    kp = detect_and_compute_orb_batch(gray[None], max_keypoints, n_levels, threshold)
    return Keypoints(*(getattr(kp, name)[0] for name in Keypoints.__dataclass_fields__))
