"""Reconstruction state: dense track table + cameras.

Port of sfm_danpipeline_tpu/pipeline/tracks.py. `track_feat[p, v]` holds
the feature index of point p in view v (or -1); the inverse map
`feat_to_point[v, k]` makes 2D-3D correspondence search a gather. Point
insertion fuses tracks that share an observation.

The state is functional, like the reference's: every operation returns a
new ReconstructionState and leaves its input unchanged (the pipeline keeps
snapshots of states across seed attempts).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from sfm_danpipeline_torch.ops.lie import exp_so3
from sfm_danpipeline_torch.ops.ransac import LINALG_BATCH


@dataclasses.dataclass(frozen=True)
class ReconstructionState:
    """Fixed-capacity reconstruction state.

    points_xyz:    (P, 3) float32
    points_rgb:    (P, 3) float32
    points_valid:  (P,)   bool
    track_feat:    (P, V) int32 — feature id of point in view, or -1
    feat_to_point: (V, K) int32 — inverse map, point id or -1
    cameras:       (V, 6) float32 — angle-axis + t (world->cam)
    camera_valid:  (V,)   bool — registered views
    focal:         ()     float32 — shared focal (BA-refined)
    n_points:      ()     int32
    """

    points_xyz: torch.Tensor
    points_rgb: torch.Tensor
    points_valid: torch.Tensor
    track_feat: torch.Tensor
    feat_to_point: torch.Tensor
    cameras: torch.Tensor
    camera_valid: torch.Tensor
    focal: torch.Tensor
    n_points: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.points_xyz.shape[0]

    @property
    def n_views(self) -> int:
        return self.track_feat.shape[1]

    @property
    def max_keypoints(self) -> int:
        return self.feat_to_point.shape[1]

    @property
    def device(self) -> torch.device:
        return self.points_xyz.device


def init_state(
    n_views: int, max_keypoints: int, capacity: int, focal: float,
    device: torch.device | str = "cpu",
) -> ReconstructionState:
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return ReconstructionState(
        points_xyz=torch.zeros((capacity, 3), **f32),
        points_rgb=torch.zeros((capacity, 3), **f32),
        points_valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        track_feat=torch.full((capacity, n_views), -1, **i32),
        feat_to_point=torch.full((n_views, max_keypoints), -1, **i32),
        cameras=torch.zeros((n_views, 6), **f32),
        camera_valid=torch.zeros((n_views,), dtype=torch.bool, device=device),
        focal=torch.tensor(focal, **f32),
        n_points=torch.tensor(0, **i32),
    )


def scatter_set_last(
    dst: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor | None, vals: torch.Tensor
) -> torch.Tensor:
    """Out-of-place dst[rows, cols] = vals (dst[rows] = vals when cols is
    None) where, among duplicate targets, the LAST entry wins.

    The reference's scatters (`.at[].set`) are last-wins with duplicate
    indices on XLA; a plain index_put leaves the winner unspecified (and
    nondeterministic on CUDA), so the winner is picked explicitly."""
    out = dst.clone()
    if cols is None:
        target = out.view(dst.shape[0], -1)
        lin = rows.long()
        vals = vals.reshape(lin.shape[0], -1)
    else:
        target = out.view(-1)
        lin = rows.long() * dst.shape[1] + cols.long()
    pos = torch.arange(lin.numel(), device=dst.device)
    winner = torch.full(
        (target.shape[0],), -1, dtype=torch.long, device=dst.device
    ).scatter_reduce(0, lin, pos, "amax")
    keep = winner[lin] == pos
    target[lin[keep]] = vals[keep].to(dst.dtype)
    return out


def add_points(
    state: ReconstructionState,
    xyz: torch.Tensor,
    rgb: torch.Tensor,
    view_a,
    feat_a: torch.Tensor,
    view_b,
    feat_b: torch.Tensor,
    mask: torch.Tensor,
    merge_distance: float = 0.01,
) -> ReconstructionState:
    """Insert triangulated candidates with track fusion (vectorized
    `mergeNewPoints`, src/Sfm.cpp:1212-1244): a candidate whose (view, feat)
    observation already belongs to a point extends that point's track;
    otherwise it appends to the next free slot. Masked entries write to a
    dump row/column that is sliced off."""
    M = xyz.shape[0]
    P = state.capacity
    Kmax = state.max_keypoints
    dev = state.device
    view_a = torch.as_tensor(view_a, dtype=torch.long, device=dev).expand(M)
    view_b = torch.as_tensor(view_b, dtype=torch.long, device=dev).expand(M)
    feat_a = feat_a.long()
    feat_b = feat_b.long()
    V = state.n_views

    track_feat = torch.cat(
        [state.track_feat, state.track_feat.new_full((1, V), -1)]
    )  # (P+1, V)
    f2p = torch.cat(
        [state.feat_to_point, state.feat_to_point.new_full((V, 1), -1)], dim=1
    )  # (V, K+1)

    pa = state.feat_to_point[view_a, torch.clamp(feat_a, min=0)].long()
    pb = state.feat_to_point[view_b, torch.clamp(feat_b, min=0)].long()
    pa = torch.where(mask & (feat_a >= 0), pa, -1)
    pb = torch.where(mask & (feat_b >= 0), pb, -1)
    fuse_target = torch.where(pa >= 0, pa, pb)
    fuse = fuse_target >= 0
    ft_c = torch.clamp(fuse_target, min=0)

    # Fusion: extend tracks of existing points.
    tgt_a = torch.where(fuse & (state.track_feat[ft_c, view_a] < 0), fuse_target, P)
    track_feat = scatter_set_last(
        track_feat, tgt_a, view_a, torch.where(tgt_a < P, feat_a, -1)
    )
    tgt_b = torch.where(fuse & (track_feat[ft_c, view_b] < 0), fuse_target, P)
    track_feat = scatter_set_last(
        track_feat, tgt_b, view_b, torch.where(tgt_b < P, feat_b, -1)
    )
    col_a = torch.where(fuse & (feat_a >= 0), feat_a, Kmax)
    f2p = scatter_set_last(f2p, view_a, col_a, torch.where(col_a < Kmax, fuse_target, -1))
    col_b = torch.where(fuse & (feat_b >= 0), feat_b, Kmax)
    f2p = scatter_set_last(f2p, view_b, col_b, torch.where(col_b < Kmax, fuse_target, -1))

    # Append new points to free slots.
    append = mask & ~fuse
    pos_in_batch = torch.cumsum(append.to(torch.int64), 0) - 1
    slot = state.n_points.long() + pos_in_batch
    in_cap = append & (slot < P)
    slot_d = torch.where(in_cap, slot, P)

    pad1 = lambda a: torch.cat([a, a.new_zeros((1,) + a.shape[1:])])  # noqa: E731
    points_xyz = scatter_set_last(pad1(state.points_xyz), slot_d, None, xyz)
    points_rgb = scatter_set_last(pad1(state.points_rgb), slot_d, None, rgb)
    points_valid = scatter_set_last(
        pad1(state.points_valid), slot_d, None, torch.ones_like(in_cap)
    )
    track_feat = scatter_set_last(track_feat, slot_d, view_a, feat_a)
    track_feat = scatter_set_last(track_feat, slot_d, view_b, feat_b)
    acol = torch.where(in_cap & (feat_a >= 0), feat_a, Kmax)
    bcol = torch.where(in_cap & (feat_b >= 0), feat_b, Kmax)
    f2p = scatter_set_last(f2p, view_a, acol, slot_d)
    f2p = scatter_set_last(f2p, view_b, bcol, slot_d)
    n_points = state.n_points + torch.sum(in_cap.to(torch.int32))

    return dataclasses.replace(
        state,
        points_xyz=points_xyz[:P],
        points_rgb=points_rgb[:P],
        points_valid=points_valid[:P],
        track_feat=track_feat[:P],
        feat_to_point=f2p[:, :Kmax],
        n_points=n_points.to(torch.int32),
    )


def find_2d3d(
    state: ReconstructionState,
    new_view,
    done_view,
    match_feat_new: torch.Tensor,
    match_feat_done: torch.Tensor,
    match_valid: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """2D-3D correspondences from matches (new view <-> done_view): a match
    yields one when feat_done belongs to a live cloud point. Inputs may
    carry leading dims (done_view then broadcasts against them). Returns
    (point_idx, feat_new, mask)."""
    p = state.feat_to_point[done_view, torch.clamp(match_feat_done, min=0).long()].long()
    mask = match_valid & (match_feat_done >= 0) & (p >= 0)
    p = torch.clamp(p, min=0)
    return p, match_feat_new, mask & state.points_valid[p]


def masked_dlt(
    state: ReconstructionState, keypoints_xy: torch.Tensor, K: torch.Tensor,
    obs_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-view DLT of every point from the observations `obs_mask` (P, V)
    selects, under the current poses: the smallest eigenvector of the
    accumulated 4x4 normal matrix (its sign cancels in X = h[:3] / h[3]).
    Returns (X (P, 3), ok (P,)): ok where >= 2 observations are selected,
    the solve is not degenerate, a majority of them see X in front, and X is
    finite."""
    P, V = state.track_feat.shape
    feat = torch.clamp(state.track_feat, min=0).long()
    xy = keypoints_xy[torch.arange(V, device=feat.device)[None, :], feat]
    xn = (xy[..., 0] - K[0, 2]) / K[0, 0]
    yn = (xy[..., 1] - K[1, 2]) / K[1, 1]
    R = exp_so3(state.cameras[:, :3])
    t = state.cameras[:, 3:]
    Pm = torch.cat([R, t[:, :, None]], dim=-1)
    r1 = xn[..., None] * Pm[None, :, 2, :] - Pm[None, :, 0, :]
    r2 = yn[..., None] * Pm[None, :, 2, :] - Pm[None, :, 1, :]
    w = obs_mask.to(torch.float32)[..., None]
    ATA = torch.einsum("pva,pvb->pab", r1 * w, r1) + torch.einsum("pva,pvb->pab", r2 * w, r2)
    n_obs = torch.sum(obs_mask, dim=1)
    # Only rows that can be used are solved, in chunks: cuSOLVER's batched
    # eigh refuses a batch the size of the whole capacity.
    h = torch.zeros((P, 4), dtype=ATA.dtype, device=ATA.device)
    for rows in torch.nonzero(n_obs >= 2)[:, 0].split(LINALG_BATCH):
        h[rows] = torch.linalg.eigh(ATA[rows])[1][..., 0]
    ok_h = torch.abs(h[:, 3]) > 1e-9
    X = h[:, :3] / torch.where(ok_h, h[:, 3], torch.ones_like(h[:, 3]))[:, None]
    z = torch.einsum("vj,pj->pv", R[:, 2, :], X) + t[None, :, 2]
    front = torch.sum((z > 0) & obs_mask, dim=1)
    ok = ok_h & (n_obs >= 2) & (front * 2 >= n_obs) & torch.all(torch.isfinite(X), dim=-1)
    return X, ok


def retriangulate_points(
    state: ReconstructionState, keypoints_xy: torch.Tensor, K: torch.Tensor
) -> ReconstructionState:
    """Re-estimate every point by multi-view DLT from its track under the
    current poses (`masked_dlt` over its live observations). Points with < 2
    live observations, a degenerate solve or a failed cheirality majority
    keep their position."""
    has = (
        (state.track_feat >= 0)
        & state.camera_valid[None, :]
        & state.points_valid[:, None]
    )
    X, ok = masked_dlt(state, keypoints_xy, K, has)
    return dataclasses.replace(
        state, points_xyz=torch.where(ok[:, None], X, state.points_xyz)
    )


def prune_observations(
    state: ReconstructionState,
    keypoints_xy: torch.Tensor,
    K: torch.Tensor,
    max_error_px: float = 6.0,
) -> ReconstructionState:
    """Drop observations reprojecting worse than `max_error_px` (or behind
    the camera) with the current cameras, invalidate points left with < 2
    observations, and rebuild the inverse map."""
    P, V = state.track_feat.shape
    feat = state.track_feat
    has_obs = feat >= 0
    R = exp_so3(state.cameras[:, :3])
    t = state.cameras[:, 3:]
    cam = torch.einsum("vij,pj->pvi", R, state.points_xyz) + t[None]
    z = torch.where(torch.abs(cam[..., 2]) < 1e-9, torch.full_like(cam[..., 2], 1e-9), cam[..., 2])
    uv = cam[..., :2] / z[..., None]
    proj = uv * torch.stack([K[0, 0], K[1, 1]]) + torch.stack([K[0, 2], K[1, 2]])
    vgrid = torch.arange(V, device=feat.device)[None, :].expand(P, V)
    obs_xy = keypoints_xy[vgrid, torch.clamp(feat, min=0).long()]
    err = torch.linalg.norm(proj - obs_xy, dim=-1)
    good = (
        has_obs & (err <= max_error_px) & (z > 0)
        & state.camera_valid[None, :] & state.points_valid[:, None]
    )
    new_feat = torch.where(good, feat, -1)
    points_valid = state.points_valid & (torch.sum(new_feat >= 0, dim=1) >= 2)
    new_feat = torch.where(points_valid[:, None], new_feat, -1)
    # Rebuild the inverse map. Each (view, feature) belongs to at most one
    # track, so these writes never collide.
    Kmax = state.max_keypoints
    f2p = torch.full((V, Kmax + 1), -1, dtype=torch.int32, device=feat.device)
    pidx = torch.arange(P, dtype=torch.int32, device=feat.device)[:, None].expand(P, V)
    col = torch.where(new_feat >= 0, new_feat, Kmax).long()
    f2p = scatter_set_last(
        f2p, vgrid.reshape(-1), col.reshape(-1),
        torch.where(new_feat >= 0, pidx, -1).reshape(-1),
    )
    return dataclasses.replace(
        state, track_feat=new_feat, points_valid=points_valid,
        feat_to_point=f2p[:, :Kmax],
    )


def live_observations(state: ReconstructionState) -> torch.Tensor:
    """(P, V) mask of the observations BA uses: tracked features of live
    points in registered views."""
    return (
        (state.track_feat >= 0)
        & state.points_valid[:, None]
        & state.camera_valid[None, :]
    )


def observation_table(
    state: ReconstructionState,
    keypoints_xy: torch.Tensor,
    principal_point: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole track table as flat (P*V,) observation rows in (point,
    view) order: (obs_cam, obs_pt, obs_xy minus the principal point, obs_w).
    Rows that are no live observation carry weight 0, which BA ignores;
    `observation_table_compact` keeps only the weighted rows."""
    P, V = state.track_feat.shape
    dev = state.track_feat.device
    obs_pt = torch.arange(P, dtype=torch.int32, device=dev).repeat_interleave(V)
    obs_cam = torch.arange(V, dtype=torch.int32, device=dev).repeat(P)
    feat = torch.clamp(state.track_feat.reshape(-1), min=0).long()
    xy = keypoints_xy[obs_cam.long(), feat] - principal_point
    return obs_cam, obs_pt, xy, live_observations(state).reshape(-1).to(torch.float32)


def observation_table_compact(
    state: ReconstructionState,
    keypoints_xy: torch.Tensor,
    principal_point: torch.Tensor,
    n_points: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The real observations of the first `n_points` track rows as flat
    (O,) rows in (point, view) order: (obs_cam, obs_pt, obs_xy minus the
    principal point, obs_w). The reference pads this table to a bucket
    (a compile-count workaround); here it has exactly the live rows."""
    P = state.capacity if n_points is None else n_points
    w_full = live_observations(state)[:P]
    pt, cam = torch.nonzero(w_full, as_tuple=True)
    feat = state.track_feat[pt, cam].long()
    xy = keypoints_xy[cam, feat] - principal_point
    return cam, pt, xy, torch.ones_like(xy[:, 0])
