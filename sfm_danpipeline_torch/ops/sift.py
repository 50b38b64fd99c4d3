"""SIFT: scale-space keypoint detection + 128-d descriptors, batched over
images.

Port of sfm_danpipeline_tpu/ops/sift.py. It computes the same detector —
Gaussian pyramid, 3x3x3 DoG extrema, 4x4 block-max candidate selection,
masked Newton refinement with integer re-walk, 36-bin orientation with a
secondary-orientation row per candidate, and the 4x4x8 trilinear
descriptor — in its natural GPU form: the pyramid blur is a separable
convolution, the extrema test a 3D max-pool, and orientation/descriptor
samples are bilinear gathers from the gradient stack (the reference's
patch hat-weight contractions compute exactly this bilinear sample).
Every function takes the whole (N, H, W) batch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sfm_danpipeline_torch.config import FeatureConfig
from sfm_danpipeline_torch.ops.interp import gather_cube
from sfm_danpipeline_torch.ops.reduce import binned_sum
from sfm_danpipeline_torch.ops.select import top_k_indices


@dataclasses.dataclass(frozen=True)
class Keypoints:
    """Fixed-shape keypoint set (leading image dim when batched).

    xy:          (..., K, 2) float32 — position in original image pixels
    sigma:       (..., K)    float32 — absolute scale in original pixels
    angle:       (..., K)    float32 — dominant orientation, radians
    response:    (..., K)    float32 — |DoG contrast|
    descriptors: (..., K, 128) float32 — L2-normalized SIFT descriptors
    valid:       (..., K)    bool
    """

    xy: torch.Tensor
    sigma: torch.Tensor
    angle: torch.Tensor
    response: torch.Tensor
    descriptors: torch.Tensor
    valid: torch.Tensor


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[n, idx[n, k], ...] for a (N, M, ...) and idx (N, k)."""
    shape = idx.shape + a.shape[2:]
    return torch.gather(
        a, 1, idx.reshape(idx.shape + (1,) * (a.dim() - 2)).expand(shape)
    )


# ---------------------------------------------------------------------------
# Gaussian pyramid
# ---------------------------------------------------------------------------


def _gaussian_kernel(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur with reflect-101 padding (cv::GaussianBlur
    BORDER_DEFAULT). img: (N, H, W)."""
    if sigma <= 0:
        return img
    k = torch.as_tensor(_gaussian_kernel(sigma), device=img.device)
    r = (k.numel() - 1) // 2
    x = F.pad(img[:, None], (r, r, 0, 0), mode="reflect")
    x = F.conv2d(x, k.view(1, 1, 1, -1))
    x = F.pad(x, (0, 0, r, r), mode="reflect")
    return F.conv2d(x, k.view(1, 1, -1, 1))[:, 0]


def _upsample2(img: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling, half-pixel centers, edge-clamped (the
    jax.image.resize "bilinear" result)."""
    return F.interpolate(
        img[:, None], scale_factor=2, mode="bilinear", align_corners=False
    )[:, 0]


def build_gaussian_octave(base: torch.Tensor, config: FeatureConfig) -> torch.Tensor:
    """One octave of S+3 progressively blurred images from `base` (N, H, W)
    at blur sigma0. Returns (N, S+3, H, W)."""
    S = config.n_scales_per_octave
    k = 2.0 ** (1.0 / S)
    levels = [base]
    sigma_prev = config.sigma0
    for i in range(1, S + 3):
        sigma_total = config.sigma0 * (k**i)
        sigma_inc = math.sqrt(max(sigma_total**2 - sigma_prev**2, 1e-12))
        levels.append(gaussian_blur(levels[-1], sigma_inc))
        sigma_prev = sigma_total
    return torch.stack(levels, dim=1)


# ---------------------------------------------------------------------------
# Extrema detection + refinement (per octave)
# ---------------------------------------------------------------------------


def _extrema_response(dog: torch.Tensor, config: FeatureConfig) -> torch.Tensor:
    """(N, S, H, W): |dog| where the voxel is a 3x3x3 extremum above the
    prefilter threshold, else 0. dog: (N, S+2, H, W)."""
    S = config.n_scales_per_octave
    prefilter = 0.5 * config.contrast_threshold / S
    mx = F.max_pool3d(dog[:, None], 3, stride=1, padding=1)[:, 0]
    mn = -F.max_pool3d(-dog[:, None], 3, stride=1, padding=1)[:, 0]
    inner = dog[:, 1 : S + 1]
    is_ext = ((inner >= mx[:, 1 : S + 1]) & (inner > prefilter)) | (
        (inner <= mn[:, 1 : S + 1]) & (inner < -prefilter)
    )
    return torch.where(is_ext, torch.abs(inner), torch.zeros_like(inner))


def _newton_step(
    dog: torch.Tensor,
    s: torch.Tensor,
    y: torch.Tensor,
    x: torch.Tensor,
    config: FeatureConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One 3x3x3 Newton solve at integer centers (Lowe 2004 §4).

    dog: (N, S+2, H, W); s, y, x: (N, K) with s indexing the inner levels.
    Returns (offset (N,K,3) [ds,dy,dx], contrast (N,K), quality_ok (N,K))."""
    N, L, H, W = dog.shape
    n = torch.arange(N, device=dog.device)[:, None]
    # Inner level s -> dog level s+1; its +-1 neighbours stay inside the
    # image's own L levels, so a flat (N*L) stack needs no per-image clamp.
    cube = gather_cube(
        dog.reshape(N * L, H, W),
        (n * L + s + 1).reshape(-1), y.reshape(-1), x.reshape(-1),
    ).reshape(N, -1, 3, 3, 3)
    c = cube[..., 1, 1, 1]
    gs = 0.5 * (cube[..., 2, 1, 1] - cube[..., 0, 1, 1])
    gy = 0.5 * (cube[..., 1, 2, 1] - cube[..., 1, 0, 1])
    gx = 0.5 * (cube[..., 1, 1, 2] - cube[..., 1, 1, 0])
    dss = cube[..., 2, 1, 1] - 2 * c + cube[..., 0, 1, 1]
    dyy = cube[..., 1, 2, 1] - 2 * c + cube[..., 1, 0, 1]
    dxx = cube[..., 1, 1, 2] - 2 * c + cube[..., 1, 1, 0]
    dsy = 0.25 * (
        cube[..., 2, 2, 1] - cube[..., 2, 0, 1] - cube[..., 0, 2, 1] + cube[..., 0, 0, 1]
    )
    dsx = 0.25 * (
        cube[..., 2, 1, 2] - cube[..., 2, 1, 0] - cube[..., 0, 1, 2] + cube[..., 0, 1, 0]
    )
    dyx = 0.25 * (
        cube[..., 1, 2, 2] - cube[..., 1, 2, 0] - cube[..., 1, 0, 2] + cube[..., 1, 0, 0]
    )
    Hmat = torch.stack(
        [
            torch.stack([dss, dsy, dsx], dim=-1),
            torch.stack([dsy, dyy, dyx], dim=-1),
            torch.stack([dsx, dyx, dxx], dim=-1),
        ],
        dim=-2,
    )
    g = torch.stack([gs, gy, gx], dim=-1)
    eye = torch.eye(3, dtype=dog.dtype, device=dog.device) * 1e-6
    # solve_ex: a singular Hessian gives a huge/non-finite offset (rejected
    # below) instead of an exception, as jnp.linalg.solve does.
    sol, _ = torch.linalg.solve_ex(Hmat + eye, g[..., None])
    offset = -sol[..., 0]
    contrast = c + 0.5 * torch.sum(g * offset, dim=-1)
    S = config.n_scales_per_octave
    contrast_ok = torch.abs(contrast) * S >= config.contrast_threshold
    tr = dxx + dyy
    det = dxx * dyy - dyx * dyx
    r = config.edge_threshold
    edge_ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)
    return offset, contrast, edge_ok & contrast_ok


def _refine_candidates(dog, s, y, x, config):
    """Iterative Newton refinement with integer re-walk (two masked
    relocation steps, then the final solve). Returns (s, y, x, offset,
    contrast, quality_ok, conv_ok)."""
    S = config.n_scales_per_octave
    H, W = dog.shape[-2:]
    border = 5
    for _ in range(2):
        offset, _, _ = _newton_step(dog, s, y, x, config)
        need = torch.any(torch.abs(offset) > 0.6, dim=-1) & torch.all(
            torch.isfinite(offset), dim=-1
        )
        # Non-finite offsets are masked by `need`; zero them before the cast.
        step = torch.clamp(
            torch.round(torch.nan_to_num(offset, 0.0, 0.0, 0.0)), -1, 1
        ).long()
        s = torch.where(need, torch.clamp(s + step[..., 0], 0, S - 1), s)
        y = torch.where(need, torch.clamp(y + step[..., 1], border, H - 1 - border), y)
        x = torch.where(need, torch.clamp(x + step[..., 2], border, W - 1 - border), x)
    offset, contrast, quality_ok = _newton_step(dog, s, y, x, config)
    conv_ok = torch.all(torch.abs(offset) <= 0.6, dim=-1) & torch.all(
        torch.isfinite(offset), dim=-1
    )
    return s, y, x, offset, contrast, quality_ok, conv_ok


# ---------------------------------------------------------------------------
# Orientation + descriptor (per octave)
# ---------------------------------------------------------------------------

_DESC_SAMPLES = 4  # samples per descriptor-bin axis -> 16x16 grid


def _gradient_stacks(gauss: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients over the last two axes, zero at the
    border. gauss: (..., H, W), e.g. the (N, L, H, W) level stack."""
    gx = torch.zeros_like(gauss)
    gx[..., 1:-1] = 0.5 * (gauss[..., 2:] - gauss[..., :-2])
    gy = torch.zeros_like(gauss)
    gy[..., 1:-1, :] = 0.5 * (gauss[..., 2:, :] - gauss[..., :-2, :])
    return gx, gy


class _PatchSampler:
    """Bilinear samples of a gradient stack inside each keypoint's
    (PH, PW) window, coordinates clamped to the window.

    The reference cuts the window out and samples it with hat-weight
    contractions (a TPU workaround for slow gathers); clamping to the
    window and gathering from the full stack gives the same values."""

    def __init__(self, gx, gy, level, y0, x0, PH, PW):
        N, L, H, W = gx.shape
        self.gx = gx.reshape(-1)
        self.gy = gy.reshape(-1)
        n = torch.arange(N, device=gx.device)[:, None]
        self.base = ((n * L + level) * (H * W))[..., None]  # (N, K, 1)
        self.y0 = y0[..., None].to(gx.dtype)
        self.x0 = x0[..., None].to(gx.dtype)
        self.PH, self.PW, self.W = PH, PW, W

    def __call__(self, xs: torch.Tensor, ys: torch.Tensor):
        """xs, ys: (N, K, S) window-local coords -> (gx, gy) samples."""
        ys = torch.clamp(ys, 0.0, self.PH - 1.0)
        xs = torch.clamp(xs, 0.0, self.PW - 1.0)
        yi = torch.floor(ys)
        xi = torch.floor(xs)
        fy = ys - yi
        fx = xs - xi
        y0 = (yi + self.y0).long()
        x0 = (xi + self.x0).long()
        # At the window's last row/column the weight of the next one is 0;
        # clamp the index so it stays inside the window.
        y1 = torch.where(fy > 0, y0 + 1, y0)
        x1 = torch.where(fx > 0, x0 + 1, x0)
        W = self.W
        i00 = self.base + y0 * W + x0
        i01 = self.base + y0 * W + x1
        i10 = self.base + y1 * W + x0
        i11 = self.base + y1 * W + x1
        out = []
        for flat in (self.gx, self.gy):
            out.append(
                flat[i00] * (1 - fx) * (1 - fy)
                + flat[i01] * fx * (1 - fy)
                + flat[i10] * (1 - fx) * fy
                + flat[i11] * fx * fy
            )
        return out


def _orientation(sample, x, y, sigma_oct, config):
    """Top-2 gradient orientations per keypoint: the dominant orientation,
    the best secondary local-max peak, and whether that peak clears 0.8x
    the dominant one (OpenCV's extra-keypoint rule). x, y, sigma_oct:
    (N, K) window-local geometry. Returns (angle1, angle2, has2)."""
    nbins = config.orientation_bins
    dev = x.device
    n = 16
    tlin = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n * 2.0 - 1.0
    tv, tu = torch.meshgrid(tlin, tlin, indexing="ij")
    tu = tu.reshape(-1)
    tv = tv.reshape(-1)
    t2 = tu * tu + tv * tv
    w = torch.where(t2 <= 1.0, torch.exp(-4.5 * t2), torch.zeros_like(t2))

    rad = (4.5 * sigma_oct)[..., None]
    gxs, gys = sample(x[..., None] + tu * rad, y[..., None] + tv * rad)
    mag = torch.sqrt(gxs * gxs + gys * gys)
    ang = torch.atan2(gys, gxs)
    fbin = (ang + math.pi) / (2.0 * math.pi) * nbins
    b0 = torch.remainder(torch.floor(fbin).long(), nbins)
    fb = fbin - torch.floor(fbin)
    # Both histograms are masked dense sums, not scatter-adds: atomics would
    # make the bins differ in the last bits from run to run on a card.
    hist = binned_sum(w * mag * (1.0 - fb), b0, nbins) + binned_sum(
        w * mag * fb, torch.remainder(b0 + 1, nbins), nbins
    )
    kern = [1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0]
    sm = sum(kern[i] * torch.roll(hist, i - 2, dims=-1) for i in range(5))
    peak = torch.argmax(sm, dim=-1)
    bins = torch.arange(nbins, device=dev)
    is_local = (sm >= torch.roll(sm, 1, dims=-1)) & (sm >= torch.roll(sm, -1, dims=-1))
    d = torch.abs(bins - peak[..., None])
    d = torch.minimum(d, nbins - d)
    sm2 = torch.where(is_local & (d >= 2), sm, torch.full_like(sm, -math.inf))
    peak2 = torch.argmax(sm2, dim=-1)
    at = lambda a, i: torch.gather(a, -1, i[..., None])[..., 0]  # noqa: E731
    has2 = at(sm2, peak2) >= 0.8 * at(sm, peak)

    def peak_angle(pk):
        lo = at(sm, torch.remainder(pk - 1, nbins))
        hi = at(sm, torch.remainder(pk + 1, nbins))
        ctr = at(sm, pk)
        denom = lo - 2.0 * ctr + hi
        safe = torch.abs(denom) > 1e-12
        interp = torch.where(
            safe, 0.5 * (lo - hi) / torch.where(safe, denom, torch.ones_like(denom)),
            torch.zeros_like(denom),
        )
        fpeak = torch.remainder(pk.to(torch.float32) + interp, nbins)
        return (fpeak / nbins) * 2.0 * math.pi - math.pi

    return peak_angle(peak), peak_angle(peak2), has2


def _descriptors(sample, x, y, sigma_oct, angle, config):
    """128-d SIFT descriptors on a fixed rotated 16x16 sample grid: 4x4
    spatial bins of width 3*sigma, 8 orientation bins, Gaussian weighting,
    trilinear binning, normalize / clip 0.2 / renormalize. (N, K) inputs,
    window-local x, y. Returns (N, K, 128)."""
    D = config.descriptor_width
    NB = config.descriptor_bins
    SS = _DESC_SAMPLES
    n = D * SS
    dev = x.device
    u = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) * (1.0 / SS) - D / 2.0
    vv, uu = torch.meshgrid(u, u, indexing="ij")
    uu = uu.reshape(-1)
    vv = vv.reshape(-1)
    gauss_w = torch.exp(-(uu * uu + vv * vv) / (2.0 * (D / 2.0) ** 2))

    hist_width = (3.0 * sigma_oct)[..., None]
    ca = torch.cos(angle)[..., None]
    sa = torch.sin(angle)[..., None]
    ox = hist_width * (uu * ca - vv * sa)
    oy = hist_width * (uu * sa + vv * ca)
    gxs, gys = sample(x[..., None] + ox, y[..., None] + oy)
    mag = torch.sqrt(gxs * gxs + gys * gys)
    ang = torch.remainder(torch.atan2(gys, gxs) - angle[..., None], 2.0 * math.pi)
    obin = ang / (2.0 * math.pi) * NB
    ub = uu + D / 2.0 - 0.5
    vb = vv + D / 2.0 - 0.5
    u0 = torch.floor(ub).long()
    v0 = torch.floor(vb).long()
    o0 = torch.floor(obin).long()
    fu = ub - u0
    fv = vb - v0
    fo = obin - o0
    w = mag * gauss_w
    # The sample grid is fixed in the keypoint frame, so the spatial part of
    # the trilinear binning is one constant (D*D, samples) matrix; only the
    # orientation bin depends on the data. Orientation weights as a masked
    # dense sum, then a matrix product: no atomics, a fixed summation order.
    spatial = torch.zeros((D * D, n * n), dtype=torch.float32, device=dev)
    cols = torch.arange(n * n, device=dev)
    for dv_ in (0, 1):
        for du_ in (0, 1):
            wt_s = (fv if dv_ else 1.0 - fv) * (fu if du_ else 1.0 - fu)
            vi = v0 + dv_
            ui = u0 + du_
            ok = (vi >= 0) & (vi < D) & (ui >= 0) & (ui < D)
            rows = torch.clamp(vi, 0, D - 1) * D + torch.clamp(ui, 0, D - 1)
            # Each (row, sample) cell is written by one (dv_, du_) only.
            spatial[rows, cols] += torch.where(ok, wt_s, torch.zeros_like(wt_s))
    ids = torch.arange(NB, device=dev)
    o0 = torch.remainder(o0, NB)[..., None]
    o1 = torch.remainder(o0 + 1, NB)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    orient = torch.where(o0 == ids, (w * (1.0 - fo))[..., None], zero) + torch.where(
        o1 == ids, (w * fo)[..., None], zero
    )  # (N, K, samples, NB)
    vec = torch.matmul(spatial, orient).reshape(x.shape + (D * D * NB,))
    norm = torch.linalg.norm(vec, dim=-1, keepdim=True) + 1e-12
    vec = torch.clamp(vec / norm, max=0.2)
    return vec / (torch.linalg.norm(vec, dim=-1, keepdim=True) + 1e-12)


# ---------------------------------------------------------------------------
# Full detector
# ---------------------------------------------------------------------------


def _detect_octave(gauss, k_octave, config):
    """Up to k_octave refined extrema per image of one octave (no
    description). gauss: (N, S+3, H, W). Returns octave-local (x, y,
    glevel, sigma_oct, |contrast|, valid), each (N, k_octave)."""
    S = config.n_scales_per_octave
    N, _, H, W = gauss.shape
    dog = gauss[:, 1:] - gauss[:, :-1]
    resp = _extrema_response(dog, config)
    border = 5
    mask = torch.zeros((H, W), dtype=torch.bool, device=gauss.device)
    mask[border:-border, border:-border] = True
    resp = torch.where(mask, resp, torch.zeros_like(resp))

    # Candidate selection: max over 4x4 blocks, then the top blocks.
    B = 4
    Hp, Wp = -(-H // B) * B, -(-W // B) * B
    resp_p = F.pad(resp, (0, Wp - W, 0, Hp - H))
    bmax = F.max_pool2d(resp_p.reshape(N * S, 1, Hp, Wp), B, B).reshape(N, -1)
    nby, nbx = Hp // B, Wp // B
    k_red = min(k_octave, S * nby * nbx)
    idx = top_k_indices(bmax, k_red)  # many zero blocks tie: lower index first
    vals = torch.gather(bmax, 1, idx)
    if k_red < k_octave:
        vals = F.pad(vals, (0, k_octave - k_red))
        idx = F.pad(idx, (0, k_octave - k_red))
    s = idx // (nby * nbx)
    rem = idx % (nby * nbx)
    by = rem // nbx
    bx = rem % nbx
    off = torch.arange(B, device=gauss.device)
    cell_y = by[..., None, None] * B + off[:, None]  # (N, k, B, 1)
    cell_x = bx[..., None, None] * B + off[None, :]  # (N, k, 1, B)
    n = torch.arange(N, device=gauss.device)[:, None, None, None]
    flat = ((n * S + s[..., None, None]) * Hp + cell_y) * Wp + cell_x
    cell = resp_p.reshape(-1)[flat].reshape(N, k_octave, B * B)
    local = torch.argmax(cell, dim=-1)
    yy = torch.clamp(by * B + local // B, 0, H - 1)
    xx = torch.clamp(bx * B + local % B, 0, W - 1)
    cand_ok = vals > 0.0

    s, yy, xx, offset, contrast, quality_ok, conv_ok = _refine_candidates(
        dog, s, yy, xx, config
    )
    valid = cand_ok & quality_ok & conv_ok
    x_ref = xx.to(torch.float32) + offset[..., 2]
    y_ref = yy.to(torch.float32) + offset[..., 1]
    s_ref = s.to(torch.float32) + 1.0 + offset[..., 0]
    sigma_oct = config.sigma0 * (2.0 ** (s_ref / S))
    glevel = torch.clamp(s + 1, 0, S + 1)
    return x_ref, y_ref, glevel, sigma_oct, torch.abs(contrast), valid


def _describe_octave(gauss, x, y, glevel, sigma_oct, resp, valid, config):
    """Orientation + descriptors for one octave's selected candidates: two
    rows per candidate (dominant and, masked, the secondary >= 0.8*max
    orientation). Returns (x2, y2, sigma2, angle2, resp2, desc2, valid2)
    with 2K rows."""
    S = config.n_scales_per_octave
    gx, gy = _gradient_stacks(gauss[:, : S + 2])
    H, W = gx.shape[-2:]
    PH = min(80, H)
    PW = min(128, W)
    y0 = torch.clamp(torch.round(y).long() - PH // 2, 0, max(H - PH, 0))
    x0 = torch.clamp(torch.round(x).long() - PW // 2, 0, max(W - PW, 0))
    sample = _PatchSampler(gx, gy, glevel, y0, x0, PH, PW)
    xl = x - x0.to(x.dtype)
    yl = y - y0.to(y.dtype)
    ang1, ang2, has2 = _orientation(sample, xl, yl, sigma_oct, config)
    dup = lambda a: torch.cat([a, a], dim=1)  # noqa: E731
    angles = torch.cat([ang1, ang2], dim=1)
    sample2 = _PatchSampler(gx, gy, dup(glevel), dup(y0), dup(x0), PH, PW)
    desc = _descriptors(sample2, dup(xl), dup(yl), dup(sigma_oct), angles, config)
    valid2 = torch.cat([valid, valid & has2], dim=1)
    return dup(x), dup(y), dup(sigma_oct), angles, dup(resp), desc, valid2


# Fraction of the keypoint budget detected per octave.
_OCTAVE_BUDGET = (0.5, 0.25, 0.125, 0.125)


def detect_and_compute_batch(
    gray: torch.Tensor, config: FeatureConfig = FeatureConfig()
) -> Keypoints:
    """SIFT keypoints + descriptors for a batch of grayscale images
    (N, H, W) in [0, 1]: config.max_keypoints rows per image with a
    validity mask."""
    k_total = config.max_keypoints
    gray = gray.to(torch.float32)
    if config.upsample:
        base = _upsample2(gray)
        first_scale = 0.5
        init_blur = config.init_blur * 2.0
    else:
        base = gray
        first_scale = 1.0
        init_blur = config.init_blur
    sigma_diff = math.sqrt(max(config.sigma0**2 - init_blur**2, 0.01))
    base = gaussian_blur(base, sigma_diff)

    S = config.n_scales_per_octave
    per_octave: List[Tuple[torch.Tensor, ...]] = []
    octave_input = base
    scale = first_scale
    for o in range(config.n_octaves):
        if min(octave_input.shape[-2:]) < 16:
            break
        frac = _OCTAVE_BUDGET[min(o, len(_OCTAVE_BUDGET) - 1)]
        k_oct = max(64, int(k_total * frac))
        gauss = build_gaussian_octave(octave_input, config)
        x, y, glevel, sig, resp, valid = _detect_octave(gauss, k_oct, config)
        # Describe only the best half of the candidates by response.
        k_desc = max(64, k_oct // 2)
        sel = top_k_indices(
            torch.where(valid, resp, torch.full_like(resp, -1.0)), k_desc
        )
        x, y, glevel, sig, resp, valid = (
            torch.gather(a, 1, sel) for a in (x, y, glevel, sig, resp, valid)
        )
        x, y, sig, ang, resp, desc, valid = _describe_octave(
            gauss, x, y, glevel, sig, resp, valid, config
        )
        per_octave.append((x * scale, y * scale, sig * scale, ang, resp, desc, valid))
        octave_input = gauss[:, S, ::2, ::2]
        scale *= 2.0

    xs, ys, sig, ang, resp, desc, valid = (
        torch.cat([p[i] for p in per_octave], dim=1) for i in range(7)
    )
    # The two rows of a secondary-orientation keypoint share one response:
    # the stable top-k keeps the dominant row first, as lax.top_k does.
    top = top_k_indices(torch.where(valid, resp, torch.full_like(resp, -1.0)), k_total)
    return Keypoints(
        xy=torch.stack([_take(xs, top), _take(ys, top)], dim=-1),
        sigma=_take(sig, top),
        angle=_take(ang, top),
        response=_take(resp, top),
        descriptors=_take(desc, top),
        valid=_take(valid, top),
    )


def detect_and_compute(
    gray: torch.Tensor, config: FeatureConfig = FeatureConfig()
) -> Keypoints:
    """SIFT keypoints + descriptors for one grayscale image (H, W)."""
    kp = detect_and_compute_batch(gray[None], config)
    return Keypoints(*(getattr(kp, f.name)[0] for f in dataclasses.fields(kp)))
