"""Pair scoring + two-view bootstrap.

Port of sfm_danpipeline_tpu/pipeline/bootstrap.py (`findBestPair` +
`baseReconstruction`, src/Sfm.cpp:408-585). Pair scoring runs every pair
in one batched computation with a leading pair axis, as the reference's
`score_pairs` does in one dispatch (there a `lax.scan`, chosen for the TPU
compiler). It is split over pairs only where the tables it holds would
outgrow the memory budget (`ops/ransac.py pair_slices`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from sfm_danpipeline_torch.config import PipelineConfig
from sfm_danpipeline_torch.ops import prng
from sfm_danpipeline_torch.ops.epipolar import estimate_relative_pose_basins
from sfm_danpipeline_torch.ops.homography import homography_ransac
from sfm_danpipeline_torch.ops.lie import log_so3
from sfm_danpipeline_torch.ops.matching import PairMatches
from sfm_danpipeline_torch.ops.projection import undistort_points
from sfm_danpipeline_torch.ops.ransac import pair_slices, sample_indices
from sfm_danpipeline_torch.ops.triangulation import triangulate_and_filter
from sfm_danpipeline_torch.pipeline.tracks import ReconstructionState, add_points


class PairScores(NamedTuple):
    pose_inlier_ratio: torch.Tensor  # (NP,), -1 where unusable
    n_matches: torch.Tensor  # (NP,)
    usable: torch.Tensor  # (NP,) >= min_pair_matches, pose ok, not planar
    h_over_e: torch.Tensor  # (NP,) homography/essential inlier ratio
    R_rel: torch.Tensor  # (NP, 2, 3, 3) both basin candidates, camera i -> j
    t_rel: torch.Tensor  # (NP, 2, 3)
    n_inliers: torch.Tensor  # (NP, 2)


def score_pair(
    key: Optional[torch.Tensor],
    m: PairMatches,
    pa: torch.Tensor,
    pb: torch.Tensor,
    K: torch.Tensor,
    dist: torch.Tensor,
    image_max_dim: float,
    config: PipelineConfig,
    samples: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Score one pair, or a batch of pairs along a leading axis of `m`,
    `pa` and `pb`: both basin-diverse relative poses, the homography
    degeneracy check (H/E inlier ratio gate), and usability. The key (one
    per pair, (..., 2)) splits into the essential and the homography key,
    as the reference's does; `samples` injects the (essential (..., H, 8),
    homography (..., H, 4)) draws in place of the keys'."""
    x1 = undistort_points(pa, K, dist)
    x2 = undistort_points(pb, K, dist)
    g = config.geometry
    k_e = k_h = None
    if samples is None:
        k_e, k_h = prng.split(key, 2).unbind(-2)
    basins = estimate_relative_pose_basins(
        k_e, x1, x2, m.valid, focal=K[0, 0], threshold_px=g.essential_threshold_px,
        n_hypotheses=g.essential_ransac_iters,
        samples=None if samples is None else samples[0],
    )
    n_pose = basins.n_inliers[..., 0]
    _, _, n_h = homography_ransac(
        k_h, pa, pb, m.valid, threshold=g.homography_threshold_factor * image_max_dim,
        n_hypotheses=g.homography_ransac_iters,
        samples=None if samples is None else samples[1],
    )
    n = torch.sum(m.valid, dim=-1)
    ratio = n_pose / torch.clamp(n, min=1)
    h_over_e = n_h / torch.clamp(n_pose, min=1)
    planar = h_over_e > g.max_seed_h_over_e
    usable = (n >= config.matching.min_pair_matches) & basins.ok[..., 0] & ~planar
    return ratio, n, usable, h_over_e, basins.R, basins.t, basins.n_inliers


def score_pairs(
    key: Optional[torch.Tensor],
    matches: PairMatches,
    keypoints_xy: torch.Tensor,
    pair_i,
    pair_j,
    K: torch.Tensor,
    dist: torch.Tensor,
    image_max_dim: float,
    config: PipelineConfig,
    samples: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> PairScores:
    """Score all pairs by pose-inlier ratio in one batched call. The key
    splits into one key per pair and each pair's into its essential and
    homography keys, as the reference's `score_pairs` splits it; every
    pair's draws are taken at once on the key's device (`samples` injects
    both, (NP, H, 8) and (NP, H, 4))."""
    g = config.geometry
    dev = keypoints_xy.device
    pi = torch.as_tensor(pair_i, dtype=torch.long, device=dev)
    pj = torch.as_tensor(pair_j, dtype=torch.long, device=dev)
    pa = keypoints_xy[pi[:, None], matches.idx_a.long()]
    pb = keypoints_xy[pj[:, None], matches.idx_b.long()]
    if samples is None:
        k_e, k_h = prng.split(prng.split(key, pi.shape[0]), 2).unbind(-2)
        samples = (
            sample_indices(k_e, matches.valid, g.essential_ransac_iters, 8),
            sample_indices(k_h, matches.valid, g.homography_ransac_iters, 4),
        )
    outs = [
        score_pair(
            None, matches.pair(c), pa[c], pb[c], K, dist, image_max_dim, config,
            samples=(samples[0][c], samples[1][c]),
        )
        for c in pair_slices(pi.shape[0], g.essential_ransac_iters, pa.shape[1], dev)
    ]
    ratio, n, usable, h_over_e, R_rel, t_rel, n_inl = (
        torch.cat([o[k] for o in outs]) for k in range(7)
    )
    return PairScores(
        pose_inlier_ratio=torch.where(usable, ratio, torch.full_like(ratio, -1.0)),
        n_matches=n.to(torch.int32),
        usable=usable,
        h_over_e=h_over_e,
        R_rel=R_rel,
        t_rel=t_rel,
        n_inliers=n_inl.to(torch.int32),
    )


def best_pair(scores: PairScores) -> torch.Tensor:
    """Argmax pose-inlier ratio among usable pairs, the lower pair on ties
    (the reference's divergence from its ascending-map first hit)."""
    return torch.argmax(scores.pose_inlier_ratio)


def bootstrap_pair(
    key: Optional[torch.Tensor],
    state: ReconstructionState,
    matches: PairMatches,
    keypoints_xy: torch.Tensor,
    colors: torch.Tensor,
    view_i: int,
    view_j: int,
    K: torch.Tensor,
    dist: torch.Tensor,
    config: PipelineConfig,
    basin: int = 0,
    samples: Optional[torch.Tensor] = None,
) -> Tuple[ReconstructionState, torch.Tensor, torch.Tensor]:
    """Two-view reconstruction seeding the map: view_i at the identity,
    view_j from basin `basin` of the relative pose, pose inliers
    triangulated under the 6 px gate and inserted with tracks.

    Returns (state, ok, med_angle_deg); ok also requires the median
    triangulation angle to clear min_seed_triangulation_angle_deg."""
    g = config.geometry
    pa = keypoints_xy[view_i][matches.idx_a.long()]
    pb = keypoints_xy[view_j][matches.idx_b.long()]
    x1 = undistort_points(pa, K, dist)
    x2 = undistort_points(pb, K, dist)
    pose = estimate_relative_pose_basins(
        key, x1, x2, matches.valid, focal=K[0, 0],
        threshold_px=g.essential_threshold_px, n_hypotheses=g.essential_ransac_iters,
        samples=samples,
    ).basin(basin)
    dev = x1.device
    eye = torch.eye(3, device=dev)
    zero = torch.zeros(3, device=dev)
    X, keep = triangulate_and_filter(
        eye, zero, pose.R, pose.t, x1, x2, pa, pb, K,
        matches.valid & pose.inliers, max_error_px=g.max_reprojection_error_px,
    )
    cameras = state.cameras.clone()
    cameras[view_i] = 0.0
    cameras[view_j] = torch.cat([log_so3(pose.R), pose.t])
    camera_valid = state.camera_valid.clone()
    camera_valid[[view_i, view_j]] = True
    state = dataclasses.replace(state, cameras=cameras, camera_valid=camera_valid)
    state = add_points(
        state, X, colors[view_i][matches.idx_a.long()], view_i, matches.idx_a,
        view_j, matches.idx_b, keep, merge_distance=g.merge_distance,
    )
    # Median triangulation angle (deg) of the accepted points.
    C2 = -pose.R.T @ pose.t
    r1 = X / (torch.linalg.norm(X, dim=-1, keepdim=True) + 1e-12)
    d2 = X - C2
    r2 = d2 / (torch.linalg.norm(d2, dim=-1, keepdim=True) + 1e-12)
    ang = torch.rad2deg(torch.arccos(torch.clamp(torch.sum(r1 * r2, dim=-1), -1.0, 1.0)))
    n_keep = torch.sum(keep)
    med_idx = torch.clamp(torch.div(n_keep - 1, 2, rounding_mode="floor"), min=0)
    med = torch.sort(torch.where(keep, ang, torch.full_like(ang, math.inf))).values[med_idx]
    med = torch.where(n_keep > 0, med, torch.zeros_like(med))
    ok = pose.ok & (n_keep >= g.min_pose_points) & (med >= g.min_seed_triangulation_angle_deg)
    return state, ok, med
