"""Pyramidal Lucas-Kanade optical-flow feature matching.

Port of sfm_danpipeline_tpu/ops/flow.py, the reference's alternative
matching path (`MatchFeatures`, src/Sfm.cpp:1399-1474):
cv::calcOpticalFlowPyrLK tracks the left image's keypoints into the right
image, then a radius match against the right image's detected keypoints
converts flow endpoints into keypoint-keypoint matches.

The classic 3-level pyramidal LK: per keypoint, iterate delta = G^-1 b over
a fixed window of bilinear samples. Every function takes a leading pair
dimension (the reference's per-keypoint vmap and per-pair map are batch
dimensions here, its scan over iterations a host loop); then one distance
matrix against the target keypoints for the radius association. This path
launches no kNN kernel.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from sfm_danpipeline_torch.ops.interp import bilinear_sample_batch
from sfm_danpipeline_torch.ops.matching import PairMatches
from sfm_danpipeline_torch.ops.select import top_k_indices

_INF = 3.4e38


def _pyramid(img: torch.Tensor, levels: int):
    """2x2 box-average pyramid over the last two axes."""
    out = [img]
    for _ in range(levels - 1):
        i = out[-1]
        h2, w2 = i.shape[-2] // 2, i.shape[-1] // 2
        out.append(
            0.25
            * (
                i[..., 0 : 2 * h2 : 2, 0 : 2 * w2 : 2]
                + i[..., 1 : 2 * h2 : 2, 0 : 2 * w2 : 2]
                + i[..., 0 : 2 * h2 : 2, 1 : 2 * w2 : 2]
                + i[..., 1 : 2 * h2 : 2, 1 : 2 * w2 : 2]
            )
        )
    return out


def _track_level(p0, flow, I0, I1, du, dv, iters):
    """One level: refine `flow` (P, K, 2) so I1(p0 + flow) ~ I0(p0)."""
    xs = p0[..., 0:1] + du  # (P, K, S)
    ys = p0[..., 1:2] + dv
    t0 = bilinear_sample_batch(I0, xs, ys)
    gx = 0.5 * (bilinear_sample_batch(I0, xs + 1, ys) - bilinear_sample_batch(I0, xs - 1, ys))
    gy = 0.5 * (bilinear_sample_batch(I0, xs, ys + 1) - bilinear_sample_batch(I0, xs, ys - 1))
    gxx = torch.sum(gx * gx, dim=-1)
    gxy = torch.sum(gx * gy, dim=-1)
    gyy = torch.sum(gy * gy, dim=-1)
    det = gxx * gyy - gxy * gxy
    ok = det > 1e-6
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    for _ in range(iters):
        t1 = bilinear_sample_batch(I1, xs + flow[..., 0:1], ys + flow[..., 1:2])
        err = t1 - t0
        bx = torch.sum(err * gx, dim=-1)
        by = torch.sum(err * gy, dim=-1)
        dx = (gyy * bx - gxy * by) * inv_det
        dy = (gxx * by - gxy * bx) * inv_det
        step = torch.where(ok[..., None], torch.stack([dx, dy], dim=-1), torch.zeros_like(flow))
        flow = flow - step
    return flow, ok


def lk_track(
    img0: torch.Tensor,
    img1: torch.Tensor,
    pts: torch.Tensor,
    valid: torch.Tensor,
    levels: int = 3,
    window: int = 21,
    iters: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Track pts from img0 to img1. img0, img1: (H, W) or (P, H, W); pts
    (K, 2) or (P, K, 2) positions in img0; valid (K,) or (P, K). Returns
    (pts1, ok) of the same leading shape.

    cv::calcOpticalFlowPyrLK semantics: coarse-to-fine refinement of a
    translation per keypoint; a track fails when it leaves the image or the
    spatial-gradient matrix is degenerate."""
    single = img0.dim() == 2
    if single:
        img0, img1, pts, valid = img0[None], img1[None], pts[None], valid[None]
    H, W = img0.shape[-2:]
    r = window // 2
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=img0.device)
    dv, du = torch.meshgrid(d, d, indexing="ij")
    du = du.reshape(-1)
    dv = dv.reshape(-1)
    pyr0 = _pyramid(img0, levels)
    pyr1 = _pyramid(img1, levels)

    flow = torch.zeros_like(pts)
    ok_all = valid
    for lvl in range(levels - 1, -1, -1):
        p0 = pts / (2.0**lvl)
        flow, ok = _track_level(p0, flow, pyr0[lvl], pyr1[lvl], du, dv, iters)
        ok_all = ok_all & ok
        if lvl > 0:
            flow = flow * 2.0
    pts1 = pts + flow
    inside = (
        (pts1[..., 0] >= 0) & (pts1[..., 0] <= W - 1)
        & (pts1[..., 1] >= 0) & (pts1[..., 1] <= H - 1)
    )
    ok_all = ok_all & inside
    return (pts1[0], ok_all[0]) if single else (pts1, ok_all)


def flow_match_pair(
    img0: torch.Tensor,
    img1: torch.Tensor,
    xy0: torch.Tensor,
    valid0: torch.Tensor,
    xy1: torch.Tensor,
    valid1: torch.Tensor,
    radius: float = 3.0,
    max_matches: int = 1024,
) -> PairMatches:
    """LK-flow matching: track img0 keypoints into img1, associate each
    tracked endpoint with the nearest img1 keypoint within `radius` px (the
    reference's radiusMatch step, src/Sfm.cpp:1433-1459). Inputs carry an
    optional leading pair dimension. `lowe` is all zeros, so `at_ratio`
    keeps every flow match."""
    pts1, ok = lk_track(img0, img1, xy0, valid0)
    # Squared distances from the coordinate differences. The reference's
    # |a|^2+|b|^2-2ab form cancels to ~0.03 px^2 in float32 at these pixel
    # coordinates (half the slots of an adjacent pair tie at 0); the slots
    # are ordered by this distance and a RANSAC draw picks a slot, so an
    # order set by rounding would give one draw other matches on the card
    # than on the CPU. Each product and sum is its own op, rounded alike on
    # both devices.
    dx = pts1[..., :, None, 0] - xy1[..., None, :, 0]
    dy = pts1[..., :, None, 1] - xy1[..., None, :, 1]
    d2 = dx * dx + dy * dy
    d2 = torch.where(valid1[..., None, :], d2, torch.full_like(d2, _INF))
    mind2, best = torch.min(d2, dim=-1)  # the first of equal minima
    bestd = torch.sqrt(mind2)
    keep = ok & (bestd <= radius)
    score = torch.where(keep, -bestd, torch.full_like(bestd, -_INF))
    k = min(max_matches, score.shape[-1])
    order = top_k_indices(score, k)
    if k < max_matches:
        order = F.pad(order, (0, max_matches - k))
    pad_mask = torch.arange(max_matches, device=order.device) < k
    dist = torch.gather(bestd, -1, order)
    return PairMatches(
        idx_a=order.to(torch.int32),
        idx_b=torch.gather(best, -1, order).to(torch.int32),
        dist=dist,
        lowe=torch.zeros_like(dist),
        valid=torch.gather(keep, -1, order) & pad_mask,
    )


def flow_match_all_pairs(
    gray: torch.Tensor,
    xy: torch.Tensor,
    valid: torch.Tensor,
    pair_i: Sequence[int],
    pair_j: Sequence[int],
    radius: float = 3.0,
    max_matches: int = 1024,
    chunk: int = 8,
) -> PairMatches:
    """flow_match_pair over a pair list: gray (V, H, W), xy (V, K, 2), valid
    (V, K). Pairs go through in chunks, which bounds the (chunk, K, window^2)
    sample tensors (about 29 MB each at K = 2048 and a 21x21 window)."""
    pi = torch.as_tensor(pair_i, dtype=torch.long, device=gray.device)
    pj = torch.as_tensor(pair_j, dtype=torch.long, device=gray.device)
    parts = []
    for s in range(0, pi.numel(), chunk):
        a, b = pi[s : s + chunk], pj[s : s + chunk]
        parts.append(
            flow_match_pair(
                gray[a], gray[b], xy[a], valid[a], xy[b], valid[b],
                radius=radius, max_matches=max_matches,
            )
        )
    return PairMatches(
        *(torch.cat([getattr(p, name) for p in parts]) for name in PairMatches.__dataclass_fields__)
    )
