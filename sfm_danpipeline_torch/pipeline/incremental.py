"""Incremental view registration: PnP + triangulation against done views.

Port of sfm_danpipeline_tpu/pipeline/incremental.py (`addMoreViews` /
`findCameraPosePNP` and the per-view triangulate/merge loop,
src/Sfm.cpp:893-1210). The all-pairs epipolar prefilter is one batched
computation over the pair axis, as the reference's vmap is (its 64-pair
chunks exist only for the TPU compiler; here the pairs are split only where
memory requires it). The reference's scans over done views are host loops
here; `done_views` is a plain list of registered view ids.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from sfm_danpipeline_torch.config import PipelineConfig
from sfm_danpipeline_torch.ops import prng
from sfm_danpipeline_torch.ops.epipolar import estimate_relative_pose
from sfm_danpipeline_torch.ops.lie import exp_so3, log_so3
from sfm_danpipeline_torch.ops.matching import PairMatches
from sfm_danpipeline_torch.ops.pnp import solve_pnp_ransac
from sfm_danpipeline_torch.ops.projection import undistort_points
from sfm_danpipeline_torch.ops.ransac import pair_slices, sample_indices
from sfm_danpipeline_torch.ops.triangulation import triangulate_and_filter
from sfm_danpipeline_torch.pipeline.tracks import (
    ReconstructionState,
    add_points,
    find_2d3d,
    live_observations,
)
from sfm_danpipeline_torch.utils import profiling


def epipolar_filter_matches(
    key: Optional[torch.Tensor],
    pn: torch.Tensor,
    pd: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    dist: torch.Tensor,
    config: PipelineConfig,
    samples: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Prune one pair's matches (pn, pd (M, 2), valid (M,)), or a batch's
    along a leading pair axis, to their two-view epipolar consensus, but
    only when the consensus is credible (pose ok, >= 2*min_pose_points
    matches, >= 30% inliers); otherwise the raw matches pass through (PnP's
    P3P draws handle the low inlier rates of wide-baseline bridges)."""
    g = config.geometry
    pose = estimate_relative_pose(
        key, undistort_points(pn, K, dist), undistort_points(pd, K, dist), valid,
        focal=K[0, 0], threshold_px=g.essential_threshold_px,
        n_hypotheses=g.prefilter_ransac_iters, samples=samples,
    )
    n = torch.sum(valid, dim=-1)
    use = pose.ok & (n >= 2 * g.min_pose_points) & (pose.n_inliers >= 0.3 * n)
    return torch.where(use[..., None], valid & pose.inliers, valid)


def epipolar_prefilter_table(
    key: Optional[torch.Tensor],
    idx_a: torch.Tensor,
    idx_b: torch.Tensor,
    valid: torch.Tensor,
    keypoints_xy: torch.Tensor,
    pair_i: Sequence[int],
    pair_j: Sequence[int],
    K: torch.Tensor,
    dist: torch.Tensor,
    config: PipelineConfig,
    n_views: int,
    samples: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Epipolar consensus of every pair's loose matches in one batched call,
    scattered into the oriented (V, V, M) validity table registration reads.
    The key splits into one key per pair, as the reference's does (its
    padding to 64-pair chunks leaves these keys as they are: a split is
    prefix-stable); `samples` injects the (P, H, 8) draws."""
    g = config.geometry
    dev = valid.device
    pi = torch.as_tensor(pair_i, dtype=torch.long, device=dev)
    pj = torch.as_tensor(pair_j, dtype=torch.long, device=dev)
    pn = keypoints_xy[pi[:, None], idx_a.long()]
    pd = keypoints_xy[pj[:, None], idx_b.long()]
    if samples is None:
        samples = sample_indices(prng.split(key, pi.shape[0]), valid, g.prefilter_ransac_iters, 8)
    filt = torch.cat([
        epipolar_filter_matches(None, pn[c], pd[c], valid[c], K, dist, config, samples=samples[c])
        for c in pair_slices(pi.shape[0], g.prefilter_ransac_iters, valid.shape[1], dev)
    ])
    out = torch.zeros((n_views, n_views, valid.shape[1]), dtype=torch.bool, device=dev)
    out[pi, pj] = filt
    out[pj, pi] = filt
    return out


def build_match_tables(
    matches: PairMatches, pair_i, pair_j, n_views: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense oriented (V, V, M) tables: feat_a[a, b] holds the matched
    feature ids in view a for the pair (a, b), for both orientations."""
    V, M = n_views, matches.idx_a.shape[1]
    dev = matches.idx_a.device
    pi = torch.as_tensor(pair_i, dtype=torch.long, device=dev)
    pj = torch.as_tensor(pair_j, dtype=torch.long, device=dev)
    feat_a = torch.zeros((V, V, M), dtype=torch.int32, device=dev)
    feat_b = torch.zeros((V, V, M), dtype=torch.int32, device=dev)
    valid = torch.zeros((V, V, M), dtype=torch.bool, device=dev)
    feat_a[pi, pj] = matches.idx_a
    feat_a[pj, pi] = matches.idx_b
    feat_b[pi, pj] = matches.idx_b
    feat_b[pj, pi] = matches.idx_a
    valid[pi, pj] = matches.valid
    valid[pj, pi] = matches.valid
    return feat_a, feat_b, valid


def register_view(
    key: Optional[torch.Tensor],
    state: ReconstructionState,
    new_view: int,
    done_views: Sequence[int],
    feat_tab_a: torch.Tensor,
    feat_tab_b: torch.Tensor,
    valid_tab: torch.Tensor,
    keypoints_xy: torch.Tensor,
    K: torch.Tensor,
    dist: torch.Tensor,
    image_max_dim: float,
    config: PipelineConfig,
    valid_tab_strict: Optional[torch.Tensor] = None,
) -> Tuple[ReconstructionState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """PnP-register `new_view` from 2D-3D correspondences through the track
    table, reading the epipolar-prefiltered loose table `valid_tab`.
    Returns (state, ok, n_inliers, n_support)."""
    dev = state.device
    dv = torch.as_tensor(list(done_views), dtype=torch.long, device=dev)
    feat_new = feat_tab_a[new_view, dv]  # (D, M)
    feat_done = feat_tab_b[new_view, dv]
    p, fnew, m = find_2d3d(state, new_view, dv[:, None], feat_new, feat_done, valid_tab[new_view, dv])
    p, fnew, m = p.reshape(-1), fnew.reshape(-1), m.reshape(-1)
    if valid_tab_strict is not None:
        _, _, m_strict = find_2d3d(
            state, new_view, dv[:, None], feat_new, feat_done, valid_tab_strict[new_view, dv]
        )
        m_strict = m_strict.reshape(-1)
    else:
        m_strict = torch.zeros_like(m)
    # One representative per cloud point (a point is reached through
    # several done views); sorting strict rows last makes the surviving
    # (highest-index) representative strict whenever one exists.
    order = torch.argsort((~m).to(torch.int8) * 2 + (m & m_strict).to(torch.int8), stable=True)
    p_s, fnew_s, m_s, strict_s = p[order], fnew[order], m[order], m_strict[order]
    idx = torch.arange(p_s.shape[0], device=dev)
    seen_slot = torch.full((state.capacity,), -1, dtype=torch.long, device=dev).scatter_reduce(
        0, torch.where(m_s, p_s, state.capacity - 1),
        torch.where(m_s, idx, torch.full_like(idx, -1)), "amax",
    )
    keep = m_s & (seen_slot[p_s] == idx)

    X = state.points_xyz[p_s]
    px = keypoints_xy[new_view][fnew_s.long()]
    xn = undistort_points(px, K, dist)
    g = config.geometry
    res = solve_pnp_ransac(
        key, X, px, xn, keep, K,
        threshold_px=g.pnp_threshold_factor * image_max_dim,
        n_hypotheses=g.pnp_ransac_iters, max_translation=g.pnp_max_translation,
        min_inliers=g.pnp_min_inliers, sample_mask=keep & strict_s,
    )
    cameras = state.cameras.clone()
    camera_valid = state.camera_valid.clone()
    cameras[new_view] = torch.where(
        res.ok, torch.cat([log_so3(res.R), res.t]), cameras[new_view]
    )
    camera_valid[new_view] = camera_valid[new_view] | res.ok
    state = dataclasses.replace(state, cameras=cameras, camera_valid=camera_valid)
    return state, res.ok, res.n_inliers, torch.sum(keep)


def triangulate_new_view(
    state: ReconstructionState,
    new_view: int,
    done_view: int,
    feat_new: torch.Tensor,
    feat_done: torch.Tensor,
    valid: torch.Tensor,
    keypoints_xy: torch.Tensor,
    colors: torch.Tensor,
    K: torch.Tensor,
    dist: torch.Tensor,
    config: PipelineConfig,
) -> Tuple[ReconstructionState, torch.Tensor]:
    """Triangulate matches (new_view, done_view) with the current poses and
    merge them into the cloud. Returns (state, n_added_or_fused)."""
    cam_n = state.cameras[new_view]
    cam_d = state.cameras[done_view]
    pn = keypoints_xy[new_view][feat_new.long()]
    pd = keypoints_xy[done_view][feat_done.long()]
    X, keep = triangulate_and_filter(
        exp_so3(cam_n[:3]), cam_n[3:], exp_so3(cam_d[:3]), cam_d[3:],
        undistort_points(pn, K, dist), undistort_points(pd, K, dist), pn, pd, K,
        valid & state.camera_valid[new_view] & state.camera_valid[done_view],
        max_error_px=config.geometry.max_reprojection_error_px,
    )
    state = add_points(
        state, X, colors[new_view][feat_new.long()], new_view, feat_new,
        done_view, feat_done, keep, merge_distance=config.geometry.merge_distance,
    )
    return state, torch.sum(keep)


def triangulate_new_view_all(
    state: ReconstructionState,
    new_view: int,
    done_views: Sequence[int],
    feat_tab_a: torch.Tensor,
    feat_tab_b: torch.Tensor,
    valid_tab: torch.Tensor,
    keypoints_xy: torch.Tensor,
    colors: torch.Tensor,
    K: torch.Tensor,
    dist: torch.Tensor,
    config: PipelineConfig,
) -> Tuple[ReconstructionState, torch.Tensor]:
    """Triangulate the new view against every done view, in order."""
    total = torch.zeros((), dtype=torch.int64, device=state.device)
    with profiling.span("triangulate", done_views=len(done_views)):
        for d in done_views:
            state, n = triangulate_new_view(
                state, new_view, int(d), feat_tab_a[new_view, d], feat_tab_b[new_view, d],
                valid_tab[new_view, d], keypoints_xy, colors, K, dist, config,
            )
            total = total + n
    return state, total


def register_and_triangulate(
    key: Optional[torch.Tensor],
    state: ReconstructionState,
    new_view: int,
    done_views: Sequence[int],
    feat_tab_a: torch.Tensor,
    feat_tab_b: torch.Tensor,
    valid_tab_loose: torch.Tensor,
    valid_tab_strict: torch.Tensor,
    keypoints_xy: torch.Tensor,
    colors: torch.Tensor,
    K: torch.Tensor,
    dist: torch.Tensor,
    image_max_dim: float,
    config: PipelineConfig,
) -> Tuple[ReconstructionState, Tuple[int, int, int, int, int]]:
    """PnP registration and, when it succeeds, triangulation against every
    done view (strict table). Returns (state, (ok, n_inliers, n_support,
    n_points, n_obs)) as host ints."""
    profiling.count("pnp_attempts")
    with profiling.span("pnp", view=new_view, done_views=len(done_views)) as sp:
        state, ok, n_inl, n_support = register_view(
            key, state, new_view, done_views, feat_tab_a, feat_tab_b, valid_tab_loose,
            keypoints_xy, K, dist, image_max_dim, config, valid_tab_strict=valid_tab_strict,
        )
        ok = bool(ok)
    profiling.annotate(sp, ok=ok)
    profiling.count("pnp_failed", int(not ok))
    if ok:
        state, _ = triangulate_new_view_all(
            state, new_view, done_views, feat_tab_a, feat_tab_b, valid_tab_strict,
            keypoints_xy, colors, K, dist, config,
        )
    n_obs = torch.sum(live_observations(state))
    return state, (
        int(ok), int(n_inl), int(n_support), int(state.n_points), int(n_obs)
    )
