"""AKAZE: nonlinear-diffusion scale space + MLDB binary descriptors.

Port of sfm_danpipeline_tpu/ops/akaze.py (the reference's AKAZE branch,
`StructFromMotion::getFeature` detector==2, src/Sfm.cpp:331-357;
Alcantarilla et al., "Fast Explicit Diffusion for Accelerated Features in
Nonlinear Scale Spaces", BMVC 2013), batched over images:

 - Nonlinear scale space by FED (fast explicit diffusion): per evolution
   level the Perona-Malik PM_G2 conductivity g = 1/(1 + |grad L|^2 / k^2) is
   computed once, then a precomputed cascade of explicit 4-neighbour stencil
   steps (tau_j from the FED cosine schedule, stability limit 0.25) advances
   the image. Dozens of small stencil steps per level: eager code whose cost
   on a card is kernel launches, not arithmetic.
 - Contrast factor k: 70th percentile of the smoothed image's gradient
   magnitude, per image.
 - Detection: scale-normalized Hessian determinant per level with
   sigma-dilated central differences, 3x3x3 extrema over each octave's
   (sublevel, y, x) volume, 4x4 block-max top-k candidate selection and a
   masked 2D Newton refinement: the machinery of ops/sift.py.
 - Orientation: SURF-style dominant direction: gradients on a
   Gaussian-weighted disc (radius 6*sigma) binned by angle, a sliding arc
   maximizing the summed gradient vector's length.
 - Descriptor: full MLDB, 486 bits = 3 channels (L, rotated Lx, Ly) x
   (2x2, 3x3, 4x4) grid means compared pairwise, sampled on one rotated
   24x24 grid. Bits are 0/1 float32 padded to 512, so squared L2 in the kNN
   kernel equals the Hamming distance; match with a ratio of ~0.9.

Disc and grid samples are plain bilinear gathers from the level stacks (the
reference cuts a patch per keypoint and samples it with hat-weight
contractions, which computes the same bilinear sample).

Reproduced from the reference as it is: each octave describes only half of
its candidate budget (`k_desc` below), which caps the keypoint yield under
`max_keypoints` even on feature-rich images.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sfm_danpipeline_torch.config import FeatureConfig
from sfm_danpipeline_torch.ops.interp import bilinear_sample_level
from sfm_danpipeline_torch.ops.reduce import binned_sum
from sfm_danpipeline_torch.ops.select import top_k_indices
from sfm_danpipeline_torch.ops.sift import (
    Keypoints,
    _gradient_stacks as _gradients,
    _take,
    gaussian_blur,
)

_TAU_MAX = 0.25  # explicit-diffusion stability limit for the 2D stencil
_DESC_GRID = 24  # lcm(2,3,4)*2 samples per axis -> exact cell means
_MLDB_BITS = 486
_MLDB_PAD = 512
_N_ANG_BINS = 42

# Fraction of the keypoint budget detected per octave (cf. ops/sift.py
# _OCTAVE_BUDGET): fine scales carry most stable keypoints.
_AKAZE_OCTAVE_BUDGET = (1.0, 0.5, 0.25, 0.25)


def _fed_tau_cascade(T: float) -> List[float]:
    """Explicit-diffusion step sizes whose sum is exactly T (FED, Grewenig
    et al. 2010): n steps support total time tau_max*(n^2+n)/3; the cosine
    schedule tau_j = tau_max / (2 cos^2(pi(2j+1)/(4n+2))) is then scaled to
    hit T exactly."""
    if T <= 0:
        return []
    n = int(math.ceil(0.5 * (math.sqrt(1.0 + 12.0 * T / _TAU_MAX) - 1.0)))
    n = max(n, 1)
    taus = [
        _TAU_MAX / (2.0 * math.cos(math.pi * (2 * j + 1) / (4 * n + 2)) ** 2)
        for j in range(n)
    ]
    scale = T / sum(taus)
    return [t * scale for t in taus]


def _edge_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Replicate-pad the last two axes of (N, H, W) by p."""
    return F.pad(x[:, None], (p, p, p, p), mode="replicate")[:, 0]


def _diffusion_step(L: torch.Tensor, g: torch.Tensor, tau: float) -> torch.Tensor:
    """One explicit step L += tau * div(g grad L) with the 4-neighbour
    half-point conductivity stencil (OpenCV nld_step_scalar semantics),
    Neumann boundary. L, g: (N, H, W)."""
    Lp = _edge_pad(L, 1)
    gp = _edge_pad(g, 1)
    flow = (
        (gp[:, 1:-1, 2:] + g) * (Lp[:, 1:-1, 2:] - L)
        + (gp[:, 1:-1, :-2] + g) * (Lp[:, 1:-1, :-2] - L)
        + (gp[:, 2:, 1:-1] + g) * (Lp[:, 2:, 1:-1] - L)
        + (gp[:, :-2, 1:-1] + g) * (Lp[:, :-2, 1:-1] - L)
    )
    return L + (0.5 * tau) * flow


def _contrast_factor(gray: torch.Tensor) -> torch.Tensor:
    """k per image (N,): 70th percentile of nonzero gradient magnitudes of
    the sigma=1 pre-smoothed image (OpenCV compute_k_percentile, 0.7)."""
    gx, gy = _gradients(gaussian_blur(gray, 1.0))
    m2 = gx * gx + gy * gy
    mag = torch.sqrt(m2[:, 1:-1, 1:-1]).reshape(gray.shape[0], -1)
    # Percentile over positive magnitudes: sorting pushes the zero entries
    # to the front, a count-based index skips them.
    n_pos = torch.sum(mag > 1e-12, dim=-1)
    srt = torch.sort(mag, dim=-1).values
    total = mag.shape[1]
    idx = total - n_pos + (0.7 * n_pos.to(torch.float32)).to(torch.int64)
    k = torch.gather(srt, 1, torch.clamp(idx, 0, total - 1)[:, None])[:, 0]
    return torch.clamp(k, min=1e-3)


def _dilated_hessian(L: torch.Tensor, step: int) -> torch.Tensor:
    """det(Hessian) with sigma-dilated central differences (the static
    per-level analogue of OpenCV's Scharr-with-hole derivatives)."""
    s = max(1, step)
    Lp = _edge_pad(L, 2 * s)
    H, W = L.shape[-2:]

    def sh(dy, dx):
        return Lp[:, 2 * s + dy : 2 * s + dy + H, 2 * s + dx : 2 * s + dx + W]

    inv = 1.0 / float(s * s)
    Lxx = (sh(0, 2 * s) - 2.0 * L + sh(0, -2 * s)) * (0.25 * inv)
    Lyy = (sh(2 * s, 0) - 2.0 * L + sh(-2 * s, 0)) * (0.25 * inv)
    Lxy = (sh(s, s) - sh(s, -s) - sh(-s, s) + sh(-s, -s)) * (0.25 * inv)
    return Lxx * Lyy - Lxy * Lxy


def _refine2d(resp, s, y, x):
    """Masked 2D Newton step on the response map of each candidate's level.
    resp (N, nsub, H, W); s, y, x (N, K). Returns (dx, dy, converged)."""
    N, nsub, H, W = resp.shape
    flat = resp.reshape(-1)
    n = torch.arange(N, device=resp.device)[:, None]

    def grab(dy, dx):
        yy = torch.clamp(y + dy, 0, H - 1)
        xx = torch.clamp(x + dx, 0, W - 1)
        return flat[((n * nsub + s) * H + yy) * W + xx]

    c = grab(0, 0)
    gx = 0.5 * (grab(0, 1) - grab(0, -1))
    gy = 0.5 * (grab(1, 0) - grab(-1, 0))
    dxx = grab(0, 1) - 2 * c + grab(0, -1)
    dyy = grab(1, 0) - 2 * c + grab(-1, 0)
    dxy = 0.25 * (grab(1, 1) - grab(1, -1) - grab(-1, 1) + grab(-1, -1))
    det = dxx * dyy - dxy * dxy
    safe = torch.abs(det) > 1e-18
    det = torch.where(safe, det, torch.ones_like(det))
    dx = -(dyy * gx - dxy * gy) / det
    dy = -(dxx * gy - dxy * gx) / det
    ok = safe & (torch.abs(dx) <= 1.0) & (torch.abs(dy) <= 1.0)
    zero = torch.zeros_like(dx)
    return torch.where(ok, dx, zero), torch.where(ok, dy, zero), ok


def _dominant_orientation(sample, x, y, sigma_oct):
    """SURF-style dominant orientation (KAZE Compute_Main_Orientation):
    gradient vectors on a Gaussian-weighted disc of radius 6*sigma, binned by
    their own angle, then a sliding circular arc of _N_ANG_BINS // 6 + 1
    bins; the arc whose summed vector is longest gives the angle.
    `sample(xs, ys)` returns the (L, gx, gy) samples at (N, K, S) positions."""
    dev = x.device
    n = 13
    t = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n * 2.0 - 1.0
    tv, tu = torch.meshgrid(t, t, indexing="ij")
    tu = tu.reshape(-1)
    tv = tv.reshape(-1)
    r2 = tu * tu + tv * tv
    # Gaussian sigma = 2.5*sigma over radius 6*sigma -> exp(-(6t)^2/(2*2.5^2)).
    w = torch.where(r2 <= 1.0, torch.exp(-2.88 * r2), torch.zeros_like(r2))
    rad = (6.0 * sigma_oct)[..., None]
    _, gx, gy = sample(x[..., None] + tu * rad, y[..., None] + tv * rad)
    gx = gx * w
    gy = gy * w
    ang = torch.atan2(gy, gx)  # [-pi, pi]
    b = torch.remainder(
        ((ang + math.pi) / (2.0 * math.pi) * _N_ANG_BINS).to(torch.int64), _N_ANG_BINS
    )
    # Masked dense sums, not scatter-adds: repeatable on a card.
    sx = binned_sum(gx, b, _N_ANG_BINS)
    sy = binned_sum(gy, b, _N_ANG_BINS)
    arc = _N_ANG_BINS // 6 + 1
    wx = torch.cat([sx, sx[..., : arc - 1]], dim=-1).unfold(-1, arc, 1).sum(-1)
    wy = torch.cat([sy, sy[..., : arc - 1]], dim=-1).unfold(-1, arc, 1).sum(-1)
    best = torch.argmax(wx * wx + wy * wy, dim=-1, keepdim=True)
    return torch.atan2(torch.gather(wy, -1, best)[..., 0], torch.gather(wx, -1, best)[..., 0])


def _mldb_pairs(d: int) -> Tuple[np.ndarray, np.ndarray]:
    idx = np.arange(d * d)
    i, j = np.meshgrid(idx, idx, indexing="ij")
    m = i < j
    return i[m], j[m]


def _mldb_descriptors(sample, x, y, sigma_oct, angle):
    """Full 486-bit MLDB: 3 channels x pairwise cell-mean comparisons over
    2x2 / 3x3 / 4x4 grids of the rotated 20*sigma patch (OpenCV
    MLDB_Full_Descriptor_Invoker with pattern size 10). (N, K) inputs ->
    (N, K, 512) float32 of {0, 1}."""
    dev = x.device
    n = _DESC_GRID
    t = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n * 2.0 - 1.0
    tv, tu = torch.meshgrid(t, t, indexing="ij")
    tu = tu.reshape(-1)
    tv = tv.reshape(-1)
    ps = (10.0 * sigma_oct)[..., None]  # pattern half-size
    ca = torch.cos(angle)[..., None]
    sa = torch.sin(angle)[..., None]
    ox = ps * (tu * ca - tv * sa)
    oy = ps * (tu * sa + tv * ca)
    L, gx, gy = sample(x[..., None] + ox, y[..., None] + oy)
    # Rotate gradients into the keypoint frame.
    rx = ca * gx + sa * gy
    ry = -sa * gx + ca * gy
    chans = torch.stack([L, rx, ry], dim=-2).reshape(x.shape + (3, n, n))
    bits = []
    for d in (2, 3, 4):
        pi_, pj_ = (torch.as_tensor(a, device=dev) for a in _mldb_pairs(d))
        c = n // d
        means = chans.reshape(x.shape + (3, d, c, d, c)).mean(dim=(-3, -1))
        means = means.reshape(x.shape + (3, d * d))
        bits.append((means[..., pi_] > means[..., pj_]).reshape(x.shape + (-1,)))
    vec = torch.cat(bits, dim=-1).to(torch.float32)
    return F.pad(vec, (0, _MLDB_PAD - _MLDB_BITS))


def _describe_octave_akaze(Ls, level, x, y, sigma_oct):
    """Orientation + MLDB for one octave's selected candidates. Ls (N, nsub,
    H, W); level, x, y, sigma_oct (N, K) octave-local."""
    N, nsub, H, W = Ls.shape
    gxs, gys = _gradients(Ls)
    stacks = [a.reshape(N * nsub, H, W) for a in (Ls, gxs, gys)]
    lvl = (torch.arange(N, device=Ls.device)[:, None] * nsub + level)[..., None]

    def sample(xs, ys):
        return [bilinear_sample_level(st, lvl, xs, ys) for st in stacks]

    ang = _dominant_orientation(sample, x, y, sigma_oct)
    desc = _mldb_descriptors(sample, x, y, sigma_oct, ang)
    return ang, desc


def _detect_octave_akaze(Ls, sigmas_oct: List[float], k_octave: int, threshold: float):
    """Up to k_octave refined Hessian extrema per image of one octave.
    Returns octave-local (x, y, level, sigma, response, valid), (N, k)."""
    N, nsub, H, W = Ls.shape
    dev = Ls.device
    # Scale-normalized Hessian responses (sigma^4 normalization folded in).
    resp = torch.stack(
        [
            _dilated_hessian(Ls[:, i], int(round(sigmas_oct[i]))) * (float(sigmas_oct[i]) ** 4)
            for i in range(nsub)
        ],
        dim=1,
    )
    mx = F.max_pool3d(resp[:, None], 3, stride=1, padding=1)[:, 0]
    is_ext = (resp >= mx) & (resp > threshold)
    border = 6
    mask = torch.zeros((H, W), dtype=torch.bool, device=dev)
    mask[border:-border, border:-border] = True
    resp_m = torch.where(is_ext & mask, resp, torch.zeros_like(resp))

    B = 4
    Hp, Wp = -(-H // B) * B, -(-W // B) * B
    resp_p = F.pad(resp_m, (0, Wp - W, 0, Hp - H))
    bmax = F.max_pool2d(resp_p, B, B).reshape(N, -1)
    nby, nbx = Hp // B, Wp // B
    k_red = min(k_octave, nsub * nby * nbx)
    idx = top_k_indices(bmax, k_red)  # zero blocks tie: lower index first
    vals = torch.gather(bmax, 1, idx)
    if k_red < k_octave:
        vals = F.pad(vals, (0, k_octave - k_red))
        idx = F.pad(idx, (0, k_octave - k_red))
    s = idx // (nby * nbx)
    rem = idx % (nby * nbx)
    by, bx = rem // nbx, rem % nbx
    off = torch.arange(B, device=dev)
    cell_y = by[..., None, None] * B + off[:, None]
    cell_x = bx[..., None, None] * B + off[None, :]
    n = torch.arange(N, device=dev)[:, None, None, None]
    flat = ((n * nsub + s[..., None, None]) * Hp + cell_y) * Wp + cell_x
    cell = resp_p.reshape(-1)[flat].reshape(N, k_octave, B * B)
    local = torch.argmax(cell, dim=-1)
    yy = torch.clamp(by * B + local // B, 0, H - 1)
    xx = torch.clamp(bx * B + local % B, 0, W - 1)
    cand_ok = vals > 0.0

    dx, dy, conv_ok = _refine2d(resp, s, yy, xx)
    x_ref = xx.to(torch.float32) + dx
    y_ref = yy.to(torch.float32) + dy
    sig_arr = torch.tensor(sigmas_oct, dtype=torch.float32, device=dev)[s]
    n2 = torch.arange(N, device=dev)[:, None]
    resp_k = resp.reshape(-1)[((n2 * nsub + s) * H + yy) * W + xx]
    return x_ref, y_ref, s, sig_arr, resp_k, cand_ok & conv_ok


def detect_and_compute_akaze_batch(
    gray: torch.Tensor, config: FeatureConfig = FeatureConfig()
) -> Keypoints:
    """AKAZE keypoints + 486-bit MLDB descriptors (0/1 float32 padded to
    512) for a batch of grayscale images (N, H, W) in [0, 1]:
    config.max_keypoints rows per image with a validity mask."""
    k_total = config.max_keypoints
    nsub = config.akaze_n_sublevels
    gray = gray.to(torch.float32)
    sigma0 = 1.6  # OpenCV AKAZE soffset
    L = gaussian_blur(gray, math.sqrt(max(sigma0**2 - 0.25, 0.01)))
    k_contrast = _contrast_factor(gray)
    k2 = (k_contrast * k_contrast)[:, None, None]

    per_octave = []
    scale = 1.0
    t_prev = 0.5 * sigma0**2
    for o in range(config.akaze_n_octaves):
        if min(L.shape[-2:]) < 32:
            break
        levels = []
        sigmas_oct = []
        for j in range(nsub):
            sigma_abs = sigma0 * (2.0 ** (o + (j + 1) / nsub))
            t_target = 0.5 * (sigma_abs / scale) ** 2
            # Evolve L from t_prev (octave-local units) to t_target.
            taus = _fed_tau_cascade(t_target - t_prev)
            if taus:
                gx, gy = _gradients(L)
                # PM_G2 conductivity; k is in absolute-gradient units of the
                # full-resolution image and shared by every octave, as
                # OpenCV's is.
                g = 1.0 / (1.0 + (gx * gx + gy * gy) / k2)
                for tau in taus:
                    L = _diffusion_step(L, g, tau)
            t_prev = t_target
            levels.append(L)
            sigmas_oct.append(sigma_abs / scale)
        Ls = torch.stack(levels, dim=1)
        frac = _AKAZE_OCTAVE_BUDGET[min(o, len(_AKAZE_OCTAVE_BUDGET) - 1)]
        k_oct = max(64, int(k_total * frac))
        x, y, lvl, sig, resp, valid = _detect_octave_akaze(
            Ls, sigmas_oct, k_oct, config.akaze_threshold
        )
        # Only the best half of the candidates by response is described.
        k_desc = max(64, k_oct // 2)
        sel = top_k_indices(torch.where(valid, resp, torch.full_like(resp, -1.0)), k_desc)
        x, y, lvl, sig, resp, valid = (
            torch.gather(a, 1, sel) for a in (x, y, lvl, sig, resp, valid)
        )
        ang, desc = _describe_octave_akaze(Ls, lvl, x, y, sig)
        per_octave.append((x * scale, y * scale, sig * scale, ang, resp, desc, valid))
        L = L[:, ::2, ::2]
        t_prev = t_prev / 4.0  # diffusion time rescales with (pixel size)^2
        scale *= 2.0

    xs, ys, sig, ang, resp, desc, valid = (
        torch.cat([p[i] for p in per_octave], dim=1) for i in range(7)
    )
    score = torch.where(valid, resp, torch.full_like(resp, -1.0))
    # Per-octave budgets can sum below k_total on tiny inputs; pad with
    # invalid rows so the output always has k_total rows.
    if score.shape[1] < k_total:
        pad = k_total - score.shape[1]
        xs, ys, sig, ang, resp = (F.pad(a, (0, pad)) for a in (xs, ys, sig, ang, resp))
        desc = F.pad(desc, (0, 0, 0, pad))
        valid = F.pad(valid, (0, pad))
        score = F.pad(score, (0, pad), value=-1.0)
    top = top_k_indices(score, k_total)
    return Keypoints(
        xy=torch.stack([_take(xs, top), _take(ys, top)], dim=-1),
        sigma=_take(sig, top),
        angle=_take(ang, top),
        response=_take(resp, top),
        descriptors=_take(desc, top),
        valid=_take(valid, top),
    )


def detect_and_compute_akaze(
    gray: torch.Tensor, config: FeatureConfig = FeatureConfig()
) -> Keypoints:
    """AKAZE keypoints + descriptors for one grayscale image (H, W)."""
    kp = detect_and_compute_akaze_batch(gray[None], config)
    return Keypoints(*(getattr(kp, name)[0] for name in Keypoints.__dataclass_fields__))
