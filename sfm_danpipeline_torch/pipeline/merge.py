"""Multi-component reconstruction merging via Sim(3) alignment.

Port of the default-path part of sfm_danpipeline_tpu/pipeline/merge.py:
`cross_component_pairs`, `views_reprojection_median` and
`merge_components`. A view set with a viewpoint break grows a second
component with the same engine (pipeline/sfm.py); the components are then
merged:

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

`block_realign` serves only guided bridging, which is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from sfm_danpipeline_torch.ops.lie import exp_so3, log_so3
from sfm_danpipeline_torch.ops.similarity import Sim3, apply_sim3
from sfm_danpipeline_torch.pipeline.tracks import ReconstructionState


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
    flat_mask = mask.reshape(-1)
    flat_pa = pa.reshape(-1)
    flat_pb = pb.reshape(-1)
    idx = torch.arange(flat_pa.numel(), device=dev)
    P = state_a.capacity
    for key_arr in (flat_pb, flat_pa):
        seen = torch.full((P + 1,), -1, dtype=torch.long, device=dev).scatter_reduce(
            0, torch.where(flat_mask, key_arr, P), torch.where(flat_mask, idx, -1), "amax"
        )
        flat_mask = flat_mask & (seen[key_arr] == idx)
    order = torch.argsort((~flat_mask).to(torch.int8), stable=True)[:max_pairs]
    pid_a = flat_pa[order]
    pid_b = flat_pb[order]
    view_a = a_grid.reshape(-1)[order]
    feat_a = torch.clamp(feat_tab_a.reshape(-1)[order], min=0).long()
    return (
        state_a.points_xyz[pid_a], state_b.points_xyz[pid_b], pid_a, pid_b,
        view_a, feat_a, flat_mask[order],
    )


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
    R_c = exp_so3(state_b.cameras[:, :3])
    t_c = state_b.cameras[:, 3:]
    R_new = torch.einsum("vij,kj->vik", R_c, sim.R)  # R_c @ R^T
    t_new = sim.s * t_c - torch.einsum("vij,j->vi", R_new, sim.t)
    cam_b = torch.cat([log_so3(R_new), t_new], dim=-1)

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
