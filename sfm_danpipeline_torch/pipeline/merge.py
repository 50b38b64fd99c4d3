"""Multi-component reconstruction merging via Sim(3) alignment.

Port of sfm_danpipeline_tpu/pipeline/merge.py. A view set with a
viewpoint break grows a second component with the same engine
(pipeline/sfm.py); the components are then merged:

 1. 3D-3D correspondences: a cross-component 2D match (feat in view a of A,
    feat in view b of B) whose both endpoints already belong to track
    points yields a pair (X_A, X_B).
 2. Sim(3) RANSAC (ops/similarity.py) aligns B onto A.
 3. Merge: B's points and cameras transform into A's frame; inlier pairs
    fuse (their tracks concatenate); the remaining B points append to free
    slots.

Camera transform: for X_A = s R X_B + t, a B camera (R_c, t_c) becomes
(R_c R^T, s t_c - R_c R^T t): camera coordinates scale uniformly by s,
which preserves projections and cheirality.

`block_realign` is the same machinery inside one reconstruction: it
re-places the block of views that guided bridging (pipeline/guided.py)
carried across a break.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from sfm_danpipeline_torch.ops.lie import exp_so3, log_so3
from sfm_danpipeline_torch.ops.similarity import Sim3, apply_sim3, estimate_sim3_reproj_ransac
from sfm_danpipeline_torch.pipeline.tracks import (
    ReconstructionState,
    masked_dlt,
    retriangulate_points,
)


def cross_component_pairs(
    state_a: ReconstructionState,
    state_b: ReconstructionState,
    feat_tab_a: torch.Tensor,  # (V, V, M) oriented match tables
    feat_tab_b: torch.Tensor,
    valid_tab: torch.Tensor,
    max_pairs: int = 4096,
) -> Tuple[torch.Tensor, ...]:
    """3D-3D correspondence candidates between two components.

    For every view pair (a registered in A, b registered in B) and every
    match (fa, fb): a candidate exists when A has a point on (a, fa) and B
    has a point on (b, fb). Each B point and then each A point keeps only
    its last candidate row (a point fuses with at most one partner, and
    repeated rows would inflate RANSAC support). Returns (X_a, X_b, pid_a,
    pid_b, view_a, feat_a, mask), the valid rows first, cut to
    `max_pairs`; (view_a, feat_a) is the A-side observation behind each
    candidate, for reprojection-scored Sim(3)."""
    V, _, M = feat_tab_a.shape
    dev = feat_tab_a.device
    av = torch.arange(V, device=dev)
    a_grid = av[:, None, None].expand(V, V, M)
    b_grid = av[None, :, None].expand(V, V, M)
    pa = state_a.feat_to_point[a_grid, torch.clamp(feat_tab_a, min=0).long()].long()
    pb = state_b.feat_to_point[b_grid, torch.clamp(feat_tab_b, min=0).long()].long()
    mask = (
        valid_tab
        & state_a.camera_valid[a_grid] & state_b.camera_valid[b_grid]
        & (feat_tab_a >= 0) & (feat_tab_b >= 0) & (pa >= 0) & (pb >= 0)
    )
    pa = torch.clamp(pa, min=0)
    pb = torch.clamp(pb, min=0)
    mask = mask & state_a.points_valid[pa] & state_b.points_valid[pb]
    pid_a, pid_b, view_a, feat_a, m = _one_per_point(
        mask, pa, pb, a_grid, feat_tab_a, state_a.capacity, max_pairs
    )
    return (
        state_a.points_xyz[pid_a], state_b.points_xyz[pid_b], pid_a, pid_b,
        view_a, feat_a, m,
    )


def _one_per_point(mask, pa, pb, a_grid, feat_tab_a, P: int, max_pairs: int):
    """The candidate rows of `mask` (over the (V, V, M) match grid) with
    each B point and then each A point keeping only its last row, valid rows
    first (stable), cut to `max_pairs`. Returns (pid_a, pid_b, view_a,
    feat_a, valid)."""
    flat_mask = mask.reshape(-1)
    flat_pa = pa.reshape(-1)
    flat_pb = pb.reshape(-1)
    dev = flat_mask.device
    idx = torch.arange(flat_pa.numel(), device=dev)
    for key_arr in (flat_pb, flat_pa):
        seen = torch.full((P + 1,), -1, dtype=torch.long, device=dev).scatter_reduce(
            0, torch.where(flat_mask, key_arr, P), torch.where(flat_mask, idx, -1), "amax"
        )
        flat_mask = flat_mask & (seen[key_arr] == idx)
    order = torch.argsort((~flat_mask).to(torch.int8), stable=True)[:max_pairs]
    view_a = a_grid.reshape(-1)[order]
    feat_a = torch.clamp(feat_tab_a.reshape(-1)[order], min=0).long()
    return flat_pa[order], flat_pb[order], view_a, feat_a, flat_mask[order]


def views_reprojection_median(
    state: ReconstructionState,
    views_mask: torch.Tensor,  # (V,) restrict to these views' observations
    keypoints_xy: torch.Tensor,  # (V, K, 2)
    K: torch.Tensor,
    points_mask: Optional[torch.Tensor] = None,  # (P,) restrict to these points
) -> float:
    """Median reprojection error (px) over the selected (point, view)
    observations under the current cameras and points: the lower middle
    element for an even count, inf when nothing is selected.

    The merge gates use it on the cross-observed points (tracks touching
    both components' views) in B's views: a Sim(3) applied consistently to
    B's points and cameras preserves B's own reprojections exactly, so only
    the fused cross-component tracks can expose a wrong-scale merge."""
    P, V = state.track_feat.shape
    feat = state.track_feat
    R = exp_so3(state.cameras[:, :3])
    t = state.cameras[:, 3:]
    cam = torch.einsum("vij,pj->pvi", R, state.points_xyz) + t[None]
    zc = cam[..., 2]
    z = torch.where(torch.abs(zc) < 1e-9, torch.full_like(zc, 1e-9), zc)
    uv = cam[..., :2] / z[..., None]
    proj = uv * torch.stack([K[0, 0], K[1, 1]]) + torch.stack([K[0, 2], K[1, 2]])
    vgrid = torch.arange(V, device=feat.device)[None, :].expand(P, V)
    obs_xy = keypoints_xy[vgrid, torch.clamp(feat, min=0).long()]
    err = torch.linalg.norm(proj - obs_xy, dim=-1)
    err = torch.where(z > 0, err, torch.full_like(err, 1e9))
    m = (
        (feat >= 0) & state.points_valid[:, None] & views_mask[None, :]
        & state.camera_valid[None, :]
    )
    if points_mask is not None:
        m = m & points_mask[:, None]
    vals = err[m]
    if vals.numel() == 0:
        return float("inf")
    return float(torch.sort(vals).values[(vals.numel() - 1) // 2])


def merge_components(
    state_a: ReconstructionState,
    state_b: ReconstructionState,
    sim: Sim3,
    pid_a: torch.Tensor,  # (N,) fuse pairs (A point, B point)
    pid_b: torch.Tensor,
    fuse_mask: torch.Tensor,  # (N,) which pairs to fuse (Sim3 inliers)
) -> ReconstructionState:
    """Merge component B (disjoint registered views) into A's frame.

    B's columns of A's track and inverse tables are empty, so fused track
    rows merge with max (missing = -1) and B's feat_to_point rows
    transplant through the point-id remap. A view registered in both keeps
    A's camera and A's inverse-map row. New points beyond the capacity P
    are dropped."""
    P = state_a.capacity
    V = state_a.n_views
    dev = state_a.device
    b_cams = state_b.camera_valid & ~state_a.camera_valid

    # Transform B's geometry into A's frame.
    xyz_b = apply_sim3(sim, state_b.points_xyz)
    cam_b = _sim3_cameras(state_b.cameras, sim)

    # Point-id remap: fused B points -> their A partner; the rest of B's
    # valid points -> fresh slots after A's n_points.
    fuse_to = torch.full((P,), -1, dtype=torch.long, device=dev).scatter_reduce(
        0, torch.where(fuse_mask, pid_b.long(), P - 1),
        torch.where(fuse_mask, pid_a.long(), -1), "amax",
    )
    is_fused = fuse_to >= 0
    appendable = state_b.points_valid & ~is_fused
    pos = torch.cumsum(appendable.to(torch.int64), 0) - 1
    slot = state_a.n_points.long() + pos
    in_cap = appendable & (slot < P)
    map_b = torch.where(is_fused, fuse_to, torch.where(in_cap, slot, -1))

    # Append new points: every target slot is distinct; the rest go to the
    # dump row P, which is cut off.
    slot_d = torch.where(in_cap, slot, P)
    pad = lambda a, fill: torch.cat([a, a.new_full((1,) + a.shape[1:], fill)])  # noqa: E731
    points_xyz = pad(state_a.points_xyz, 0)
    points_rgb = pad(state_a.points_rgb, 0)
    points_valid = pad(state_a.points_valid, False)
    track_feat = pad(state_a.track_feat, -1)
    points_xyz[slot_d] = xyz_b
    points_rgb[slot_d] = state_b.points_rgb
    points_valid[slot_d] = True
    track_feat[slot_d] = state_b.track_feat

    # Fuse the tracks of inlier pairs (B's view columns are empty in A).
    fused_rows = torch.where(is_fused[:, None], state_b.track_feat, -1)
    tgt = torch.where(is_fused, fuse_to, P)
    track_feat = track_feat.scatter_reduce(
        0, tgt[:, None].expand(P, V), fused_rows, "amax"
    )

    # Inverse map: B's registered views adopt B's table through map_b.
    f2p_b = map_b[torch.clamp(state_b.feat_to_point, min=0).long()]
    f2p_b = torch.where(state_b.feat_to_point >= 0, f2p_b, -1).to(torch.int32)
    feat_to_point = torch.where(b_cams[:, None], f2p_b, state_a.feat_to_point)

    cameras = torch.where(b_cams[:, None], cam_b, state_a.cameras)
    return dataclasses.replace(
        state_a,
        points_xyz=points_xyz[:P],
        points_rgb=points_rgb[:P],
        points_valid=points_valid[:P],
        track_feat=track_feat[:P],
        feat_to_point=feat_to_point,
        cameras=cameras,
        camera_valid=state_a.camera_valid | b_cams,
        n_points=(state_a.n_points + torch.sum(in_cap.to(torch.int32))).to(torch.int32),
    )


def _sim3_cameras(cameras: torch.Tensor, sim: Sim3) -> torch.Tensor:
    """Cameras (V, 6) re-expressed after the world moves by X' = s R X + t:
    (R_c R^T, s t_c - R_c R^T t)."""
    R_new = torch.einsum("vij,kj->vik", exp_so3(cameras[:, :3]), sim.R)
    t_new = sim.s * cameras[:, 3:] - torch.einsum("vij,j->vi", R_new, sim.t)
    return torch.cat([log_so3(R_new), t_new], dim=-1)


def block_realign(
    gen: Optional[torch.Generator],
    state: ReconstructionState,
    b_mask: torch.Tensor,  # (V,) the guided-rooted view block
    feat_tab_a: torch.Tensor,  # (V, V, M) oriented match tables
    feat_tab_b: torch.Tensor,
    valid_tab: torch.Tensor,  # strict-ratio validity
    keypoints_xy: torch.Tensor,
    K: torch.Tensor,
    threshold_px: float = 6.0,
    n_hypotheses: int = 16384,
    max_pairs: int = 4096,
    samples: Optional[torch.Tensor] = None,
):
    """Sim(3) re-placement of a view block inside one reconstruction.

    Guided bridge registration carries a view block across a viewpoint
    break on 2D evidence alone; on near-periodic structure those
    associations can settle the block into a plausible but wrong basin that
    LM cannot leave. The alias-resistant signal is structural, each side's
    own 3D geometry, as in the component merge:

      1. candidate 3D-3D pairs from strict cross-block matches whose
         endpoints belong to single-sided tracks (an A-pure point and a
         B-pure point, each seen from >= 2 views of its side only), plus
         every cross track triangulated twice, from its A observations and
         from its B observations alone;
      2. reprojection-scored Sim(3) RANSAC finds the block's rigid
         correction (`n_hypotheses` draws from `gen`; or `samples`, the
         (n_hypotheses, 3) draws indexing the candidate table, or a function
         of the table's validity mask that returns them);
      3. when it succeeds: B's cameras and B-pure points move, the inlier
         pure pairs fuse (their disjoint track rows concatenate), and every
         point is re-triangulated under the corrected poses.

    The caller follows with BA and a snapshot-compare revert gate. Returns
    (state, stats) with stats = {ok, n_inliers, n_candidates, scale}."""
    P = state.capacity
    V = state.n_views
    dev = state.device
    has = (state.track_feat >= 0) & state.camera_valid[None, :] & state.points_valid[:, None]
    hasA = has & ~b_mask[None, :]
    hasB = has & b_mask[None, :]
    nA = torch.sum(hasA, dim=1)
    nB = torch.sum(hasB, dim=1)
    a_pure = (nA >= 2) & (nB == 0)
    b_pure = (nB >= 2) & (nA == 0)

    # Candidate pairs from the strict cross-block match tables.
    M = feat_tab_a.shape[2]
    av = torch.arange(V, device=dev)
    a_grid = av[:, None, None].expand(V, V, M)
    b_grid = av[None, :, None].expand(V, V, M)
    pa = state.feat_to_point[a_grid, torch.clamp(feat_tab_a, min=0).long()].long()
    pb = state.feat_to_point[b_grid, torch.clamp(feat_tab_b, min=0).long()].long()
    pac, pbc = torch.clamp(pa, min=0), torch.clamp(pb, min=0)
    mask = (
        valid_tab
        & ~b_mask[a_grid] & state.camera_valid[a_grid]
        & b_mask[b_grid] & state.camera_valid[b_grid]
        & (feat_tab_a >= 0) & (feat_tab_b >= 0) & (pa >= 0) & (pb >= 0)
        & a_pure[pac] & b_pure[pbc]
    )
    pid_a, pid_b, view_a, feat_a, m = _one_per_point(
        mask, pac, pbc, a_grid, feat_tab_a, P, max_pairs
    )

    # Cross tracks, triangulated once per side: a guided run fuses many
    # points into cross tracks (the pure-pure pool starves), but each side's
    # own observations still carry its internally consistent geometry.
    X_Ad, okA = masked_dlt(state, keypoints_xy, K, hasA)
    X_Bd, okB = masked_dlt(state, keypoints_xy, K, hasB)
    cross = (nA >= 2) & (nB >= 2) & okA & okB & state.points_valid
    va_c = torch.argmax(hasA.to(torch.int8), dim=1)  # first A view with an observation
    fa_c = torch.clamp(state.track_feat[torch.arange(P, device=dev), va_c], min=0).long()
    c_order = torch.argsort((~cross).to(torch.int8), stable=True)[:max_pairs]

    m_all = torch.cat([m, cross[c_order]])
    if callable(samples):
        samples = samples(m_all)
    simres = estimate_sim3_reproj_ransac(
        gen,
        torch.cat([state.points_xyz[pid_b], X_Bd[c_order]]),
        torch.cat([state.points_xyz[pid_a], X_Ad[c_order]]),
        torch.cat([state.cameras[view_a], state.cameras[va_c[c_order]]]),
        torch.cat([keypoints_xy[view_a, feat_a], keypoints_xy[va_c[c_order], fa_c[c_order]]]),
        K, m_all, threshold_px=threshold_px, n_hypotheses=n_hypotheses, min_inliers=8,
        samples=samples,
    )
    stats = dict(
        ok=bool(simres.ok), n_inliers=int(simres.n_inliers),
        n_candidates=int(torch.sum(m_all)),
        scale=float(simres.sim.s),
    )
    if not stats["ok"]:
        return state, stats

    sim = simres.sim
    move_cam = b_mask & state.camera_valid
    cameras = torch.where(move_cam[:, None], _sim3_cameras(state.cameras, sim), state.cameras)
    points_xyz = torch.where(b_pure[:, None], apply_sim3(sim, state.points_xyz), state.points_xyz)
    # Fuse the inlier pure pairs (the first block of the candidate table):
    # pb's B-side track row folds into pa (disjoint view columns: pa is
    # A-pure, pb B-pure), pb dies, and pb's features point to pa. The
    # split-DLT cross pairs are one point already.
    fuse = m & simres.inliers[: m.shape[0]]
    fuse_to = torch.full((P,), -1, dtype=torch.long, device=dev).scatter_reduce(
        0, torch.where(fuse, pid_b, P - 1), torch.where(fuse, pid_a, -1), "amax"
    )
    is_fused = fuse_to >= 0
    fused_rows = torch.where(is_fused[:, None], state.track_feat, -1)
    tgt = torch.where(is_fused, fuse_to, P)
    track_feat = torch.cat([state.track_feat, state.track_feat.new_full((1, V), -1)])
    track_feat = track_feat.scatter_reduce(0, tgt[:, None].expand(P, V), fused_rows, "amax")
    remap = torch.where(is_fused, fuse_to, torch.arange(P, device=dev))
    f2p = state.feat_to_point
    f2p = torch.where(f2p >= 0, remap[torch.clamp(f2p, min=0).long()], -1).to(torch.int32)
    state = dataclasses.replace(
        state, cameras=cameras, points_xyz=points_xyz, track_feat=track_feat[:P],
        points_valid=state.points_valid & ~is_fused, feat_to_point=f2p,
    )
    return retriangulate_points(state, keypoints_xy, K), stats
