"""Guided bridge registration: map-projection matching for views that fail
transitive 2D-3D registration.

Port of sfm_danpipeline_tpu/pipeline/guided.py. The incremental loop builds
2D-3D support transitively: a new view's keypoints reach 3D points only
through a pairwise descriptor match with a view that already observes them
(find2D3DMatches, src/Sfm.cpp:1011-1090), and the reference loses every
view whose pairwise matches across a viewpoint break are too thin for PnP
(src/Sfm.cpp:955-958).

Guided matching removes that bottleneck. Once a coarse pose for the new view
exists, every map point is projected into it and matched directly against
the view's keypoints under a projection-locality gate; the spatial prior
does the ratio test's work, so the support grows by an order of magnitude.
The coarse pose comes from the pose graph:

  1. the relative rotation to the best-matched registered view is known
     from two-view scoring (both epipolar basins), which fixes 5 of 6 DOF;
  2. the baseline scale is one scalar: anchored by the strict matches whose
     registered-side feature is already a track (track depth / unit-baseline
     depth), then swept over a grid, each (basin, scale) counting the points
     that project near one of their two most descriptor-affine keypoints;
  3. guided matching at the swept pose feeds the same PnP RANSAC as normal
     registration;
  4. a second, tighter guided round at the PnP pose expands the support
     before the final Gauss-Newton polish and the acceptance test.

The reference packs this into one fixed-shape program over a point bucket;
here it runs over the map's live point slots [0, n_points) as eager torch
ops. The (K, B) descriptor affinity is one plain matrix product (TF32 is
off for the package).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from sfm_danpipeline_torch.config import PipelineConfig
from sfm_danpipeline_torch.ops.lie import exp_so3, log_so3
from sfm_danpipeline_torch.ops.pnp import _gauss_newton_refine, _reproj_errors_px, solve_pnp_ransac
from sfm_danpipeline_torch.ops.projection import undistort_points
from sfm_danpipeline_torch.ops.select import top_k_indices
from sfm_danpipeline_torch.pipeline.tracks import ReconstructionState, live_observations


def _project(
    X: torch.Tensor, R: torch.Tensor, t: torch.Tensor, K: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel projections (..., N, 2) and the in-front mask (..., N) of X
    (N, 3) through poses R (..., 3, 3), t (..., 3)."""
    cam = X @ R.transpose(-1, -2) + t[..., None, :]
    zc = cam[..., 2:3]
    z = torch.where(torch.abs(zc) < 1e-9, torch.full_like(zc, 1e-9), zc)
    px = cam[..., :2] / z * torch.stack([K[0, 0], K[1, 1]]) + torch.stack([K[0, 2], K[1, 2]])
    return px, cam[..., 2] > 0


def _rep_descriptors(
    state: ReconstructionState,
    descriptors: torch.Tensor,  # (V, K, D)
    done_mask: torch.Tensor,  # (V,)
    d_star: int,
    n: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One representative descriptor for each of the first `n` points: its
    observation in the anchor view d_star (the registered view nearest the
    bridge, the most matchable across the break), else the one in the
    observing registered view whose camera centre is nearest d_star's.
    Returns (desc (n, D), has_obs (n,))."""
    tf = state.track_feat[:n]
    V = tf.shape[1]
    R_all = exp_so3(state.cameras[:, :3])
    C_all = -torch.einsum("vij,vi->vj", R_all, state.cameras[:, 3:])
    d2 = torch.sum((C_all - C_all[d_star]) ** 2, dim=-1)
    pref = torch.where(torch.arange(V, device=d2.device) == d_star, torch.full_like(d2, -1.0), d2)
    observing = (tf >= 0) & done_mask[None, :]
    score = torch.where(observing, -pref[None, :], torch.full_like(observing, float("-inf"), dtype=d2.dtype))
    rep_view = torch.argmax(score, dim=-1)  # the first maximum, as jnp.argmax
    has = torch.any(observing, dim=-1)
    feat = torch.clamp(tf[torch.arange(n, device=tf.device), rep_view], min=0).long()
    return descriptors[rep_view, feat], has


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """The median of the non-NaN entries of 1-D x, the mean of the middle two
    for an even count (numpy's and JAX's linear quantile, which
    torch.nanmedian is not); NaN when there is none."""
    v = torch.sort(x).values  # NaN sorts last
    n = torch.sum(~torch.isnan(x)).to(x.dtype)
    q = 0.5 * (n - 1.0)
    lo, hi = torch.floor(q), torch.ceil(q)
    w_hi = q - lo
    w_lo = 1.0 - w_hi
    lo = torch.clamp(torch.minimum(lo, n - 1.0), min=0.0).long()
    hi = torch.clamp(torch.minimum(hi, n - 1.0), min=0.0).long()
    return v[lo] * w_lo + v[hi] * w_hi


def _anchored_scales(
    R_dn, t_dn, sweep_s, yd, yn, z_track, anch
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 0 for both basins: each anchored match gives s = z_track /
    z_unit (its track's depth in d_star over the two-ray depth at unit
    baseline); the mode over the wide grid wins (a bridge edge's estimates
    are multimodal on repeated structure, and a median would land between
    modes), refined as the median of the winning cell's members. Returns
    (s_ref (2,), n_near (2,))."""
    a = torch.cross(yn[None].expand(2, -1, -1), yd @ R_dn.transpose(-1, -2), dim=-1)
    c = torch.cross(yn[None].expand(2, -1, -1), t_dn[:, None, :].expand_as(a), dim=-1)
    z_unit = -torch.sum(a * c, -1) / torch.clamp(torch.sum(a * a, -1), min=1e-12)
    s_i = z_track / torch.where(z_unit > 1e-6, z_unit, torch.full_like(z_unit, float("nan")))
    s_max = torch.max(torch.abs(sweep_s))
    okr = anch & (z_track > 1e-6) & torch.isfinite(s_i) & (s_i > 0.0) & (s_i <= s_max)
    s_i = torch.nan_to_num(s_i, nan=-1.0)
    tol = 0.05 * torch.abs(sweep_s)
    votes = torch.sum(
        okr[:, None, :] & (torch.abs(s_i[:, None, :] - sweep_s[None, :, None]) <= tol[None, :, None]),
        dim=2,
    )
    s0 = sweep_s[torch.argmax(votes, dim=1)]
    near = okr & (torch.abs(s_i - s0[:, None]) <= 0.07 * torch.abs(s0[:, None]))
    s_ref = torch.stack([
        _nanmedian(torch.where(near[b], s_i[b], torch.full_like(s_i[b], float("nan"))))
        for b in range(2)
    ])
    return torch.nan_to_num(s_ref, nan=1.0), torch.sum(near, dim=1)


def guided_bridge_register(
    key: Optional[torch.Tensor],
    state: ReconstructionState,
    new_view: int,
    done_views: Sequence[int],
    d_star: int,
    R_dn: torch.Tensor,  # (2, 3, 3) basin relative rotations d_star -> new
    t_dn: torch.Tensor,  # (2, 3) unit relative translation directions
    sweep_s: torch.Tensor,  # (S,) wide grid of candidate baseline scales
    keypoints_xy: torch.Tensor,  # (V, K, 2)
    descriptors: torch.Tensor,  # (V, K, D)
    kp_valid: torch.Tensor,  # (V, K)
    colors: torch.Tensor,
    feat_tab_a: torch.Tensor,
    feat_tab_b: torch.Tensor,
    valid_tab_strict: torch.Tensor,
    K_mat: torch.Tensor,
    dist: torch.Tensor,
    image_max_dim: float,
    image_size: Tuple[int, int],  # (height, width)
    b_med: float,  # typical registered-camera spacing (world units)
    config: PipelineConfig,
    samples=None,
):
    """Register `new_view` by guided map-projection matching (module
    docstring). `samples` injects the PnP RANSAC draws of
    `ops.pnp.pnp_sample_draws`, or is a function of the PnP's validity mask
    (the first guided round's keep mask) that returns them. Returns (state,
    stats) with stats = {ok, n_inliers, n_support, n_points, n_obs} as normal
    registration reports them, plus the diagnostics {n_anchored (2,), basin,
    scale, votes}; the state is unchanged unless ok."""
    from sfm_danpipeline_torch.pipeline.incremental import triangulate_new_view_all

    g = config.geometry
    dev = state.device
    V = keypoints_xy.shape[0]
    B = int(state.n_points)  # points occupy slots [0, n_points)
    done_mask = torch.zeros((V,), dtype=torch.bool, device=dev)
    done_mask[list(done_views)] = True

    X = state.points_xyz[:B]
    rep_desc, has_obs = _rep_descriptors(state, descriptors, done_mask, d_star, B)
    pt_ok = state.points_valid[:B] & has_obs
    kp_xy = keypoints_xy[new_view]
    kv = kp_valid[new_view]
    Kk = kp_xy.shape[0]
    # Descriptor affinity: L2-normalized SIFT, so ||a - b||^2 = 2 - 2 a.b.
    desc_d2 = torch.clamp(2.0 - 2.0 * (descriptors[new_view] @ rep_desc.T), min=0.0)  # (K, B)

    # Absolute-pose candidates per basin: x_new = R_dn x_d + s t_dn and
    # x_d = R_d x_w + t_d give R_new = R_dn R_d, t_new(s) = R_dn t_d + s t_dn.
    cam_d = state.cameras[d_star]
    R_d = exp_so3(cam_d[:3])
    t_d = cam_d[3:]
    R_cand = torch.einsum("bij,jk->bik", R_dn, R_d)
    t_base = torch.einsum("bij,j->bi", R_dn, t_d)

    # Stage 0: the anchored baseline scale. Each strict (new, d_star) match
    # whose d_star feature already belongs to a track fixes s outright; it
    # runs through d_star's own feature, not a cross-view descriptor search,
    # so repeated structure cannot alias it.
    fn_e = feat_tab_a[new_view, d_star].long()
    fd_e = feat_tab_b[new_view, d_star].long()
    pid_e = state.feat_to_point[d_star, fd_e].long()
    pid_c = torch.clamp(pid_e, min=0)
    anch = valid_tab_strict[new_view, d_star] & (pid_e >= 0) & state.points_valid[pid_c]
    z_track = (state.points_xyz[pid_c] @ R_d.T + t_d)[:, 2]

    def bearing(px):
        x = (px[:, 0] - K_mat[0, 2]) / K_mat[0, 0]
        y = (px[:, 1] - K_mat[1, 2]) / K_mat[1, 1]
        v = torch.stack([x, y, torch.ones_like(x)], dim=-1)
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)

    s_med, n_anch = _anchored_scales(
        R_dn, t_dn, sweep_s, bearing(keypoints_xy[d_star, fd_e]),
        bearing(keypoints_xy[new_view, fn_e]), z_track, anch,
    )
    S = sweep_s.shape[0]
    fine = torch.linspace(0.75, 1.25, S, device=dev)

    # Stage 1: the scale sweep. Each point's two most descriptor-affine
    # keypoints; a (basin, s) candidate scores one vote per point whose
    # projection lands within the sweep radius of one of them.
    d2_for_top = torch.where(
        kv[:, None] & pt_ok[None, :], desc_d2, torch.full_like(desc_d2, float("inf"))
    )
    top_kp = top_k_indices(-d2_for_top.T, 2)  # (B, 2), lower index first on ties
    top_d2 = torch.gather(d2_for_top.T, 1, top_kp)
    cand_xy = kp_xy[top_kp]  # (B, 2, 2)
    cand_ok = (top_d2 <= g.guided_sweep_desc_threshold**2) & pt_ok[:, None]
    H_img, W_img = image_size
    # Anchored basins sweep a fine grid around their anchored scale; thin
    # edges (too few anchored matches) fall back to the wide grid.
    grid_b = torch.where((n_anch >= 8)[:, None], s_med[:, None] * fine[None, :], sweep_s[None, :])
    t_grid = t_base[:, None, :] + grid_b[..., None] * t_dn[:, None, :]  # (2, S, 3)
    px, front = _project(X, R_cand[:, None].expand(2, S, 3, 3), t_grid, K_mat)  # (2, S, B, .)
    inb = (px[..., 0] >= 0) & (px[..., 0] <= W_img) & (px[..., 1] >= 0) & (px[..., 1] <= H_img)
    d = torch.linalg.norm(cand_xy - px[..., None, :], dim=-1)  # (2, S, B, 2)
    hit = torch.any(cand_ok & (d <= g.guided_sweep_radius_px), dim=-1)
    votes = torch.sum(hit & front & inb, dim=-1)  # (2, S)
    flat = int(torch.argmax(votes.reshape(-1)))
    basin, k_best = flat // S, flat % S
    s_best = grid_b[basin, k_best]
    R0 = R_cand[basin]
    t0 = t_base[basin] + s_best * t_dn[basin]

    desc_thr2 = g.guided_desc_threshold**2

    def guided_match(R, t, radius):
        """Each keypoint's best map point under projection locality, one
        keypoint per point (the best descriptor distance wins, the lower
        rank on ties). Returns (pid (K,), keep (K,))."""
        p, fr = _project(X, R, t, K_mat)
        pd = torch.linalg.norm(kp_xy[:, None, :] - p[None, :, :], dim=-1)  # (K, B)
        ok = kv[:, None] & (pt_ok & fr)[None, :] & (pd <= radius) & (desc_d2 <= desc_thr2)
        cost = torch.where(ok, desc_d2, torch.full_like(desc_d2, float("inf")))
        pid = torch.argmin(cost, dim=-1)
        best = cost[torch.arange(Kk, device=dev), pid]
        keep = torch.isfinite(best)
        order = torch.sort(torch.where(keep, best, torch.full_like(best, float("inf"))), stable=True).indices
        pid_s, keep_s = pid[order], keep[order]
        rank = torch.arange(Kk, device=dev)
        first = torch.full((B,), Kk, dtype=torch.long, device=dev).scatter_reduce(
            0, torch.where(keep_s, pid_s, B - 1), torch.where(keep_s, rank, Kk), "amin"
        )
        keep_s = keep_s & (first[pid_s] == rank)
        inv = torch.sort(order, stable=True).indices
        return pid, keep_s[inv]

    # Stage 2: guided match at the swept pose -> PnP RANSAC.
    pid1, keep1 = guided_match(R0, t0, g.guided_radius_px)
    thr = g.pnp_threshold_factor * image_max_dim
    if callable(samples):
        samples = samples(keep1)
    res = solve_pnp_ransac(
        key, X[pid1], kp_xy, undistort_points(kp_xy, K_mat, dist), keep1, K_mat,
        threshold_px=thr, n_hypotheses=g.pnp_ransac_iters, max_translation=g.pnp_max_translation,
        min_inliers=g.pnp_min_inliers, sample_mask=keep1, samples=samples,
    )

    # Stage 3: re-match at the PnP pose with the tight radius and polish.
    # Acceptance follows the final refined consensus: a wrong pose cannot
    # survive the tight re-match. A pose on top of a registered camera is
    # the degenerate small-baseline attractor of the sweep, not a bridge.
    pid2, keep2 = guided_match(res.R, res.t, g.guided_radius2_px)
    X2 = X[pid2]
    R2, t2 = _gauss_newton_refine(res.R, res.t, X2, kp_xy, K_mat, keep2.to(X.dtype))
    err = _reproj_errors_px(torch.cat([R2, t2[:, None]], -1), X2, kp_xy, K_mat)
    inl = (err < thr) & keep2
    n_inl = int(torch.sum(inl))
    center = -R2.T @ t2
    C_all = -torch.einsum("vij,vi->vj", exp_so3(state.cameras[:, :3]), state.cameras[:, 3:])
    dcam = torch.linalg.norm(C_all - center[None, :], dim=-1)
    dmin = float(torch.min(torch.where(done_mask, dcam, torch.full_like(dcam, float("inf")))))
    ok = (
        float(torch.abs(torch.linalg.det(R2) - 1.0)) < 1e-3
        and float(torch.linalg.norm(center)) <= g.pnp_max_translation
        and n_inl >= g.pnp_min_inliers
        and dmin >= 0.25 * b_med
    )

    if ok:
        # Commit: the pose, the guided observations (track extension), then
        # triangulation against every registered view as normal
        # registration does.
        cameras = state.cameras.clone()
        cameras[new_view] = torch.cat([log_so3(R2), t2])
        camera_valid = state.camera_valid.clone()
        camera_valid[new_view] = True
        # Never overwrite an existing observation of a point in this view;
        # the dedup above leaves at most one keypoint per point.
        add = inl & g.guided_keep_obs & (state.track_feat[pid2, new_view] < 0)
        track_feat = state.track_feat.clone()
        feat_to_point = state.feat_to_point.clone()
        track_feat[pid2[add], new_view] = torch.nonzero(add)[:, 0].to(track_feat.dtype)
        feat_to_point[new_view] = torch.where(add, pid2.to(feat_to_point.dtype), feat_to_point[new_view])
        state = dataclasses.replace(
            state, cameras=cameras, camera_valid=camera_valid, track_feat=track_feat,
            feat_to_point=feat_to_point,
        )
        state = triangulate_new_view_all(
            state, new_view, done_views, feat_tab_a, feat_tab_b, valid_tab_strict,
            keypoints_xy, colors, K_mat, dist, config,
        )
    stats = dict(
        ok=ok, n_inliers=n_inl, n_support=int(torch.sum(keep1)), n_points=int(state.n_points),
        n_obs=int(torch.sum(live_observations(state))), n_anchored=n_anch.tolist(),
        basin=basin, scale=float(s_best), votes=int(votes.reshape(-1)[flat]),
    )
    return state, stats
