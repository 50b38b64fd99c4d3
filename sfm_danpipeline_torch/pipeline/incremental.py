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
import logging
from collections import OrderedDict
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from sfm_danpipeline_torch.config import PipelineConfig
from sfm_danpipeline_torch.ops import prng
from sfm_danpipeline_torch.ops.epipolar import estimate_relative_pose
from sfm_danpipeline_torch.ops.lie import exp_so3, log_so3
from sfm_danpipeline_torch.ops.matching import PairMatches
from sfm_danpipeline_torch.ops.pnp import PRESCORE_ROWS, solve_pnp_ransac
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
from sfm_danpipeline_torch.utils.cuda_graphs import cached_graph

log = logging.getLogger("sfm_danpipeline_torch")


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


class MatchTables(NamedTuple):
    """One set's oriented (V, V, M) match tables: the loose-ratio matches'
    feature ids in view a and in view b of each pair (a, b), the ratio
    test's (strict) valid mask, and the loose valid mask after the epipolar
    prefilter (`epipolar_prefilter_table`). Registration reads `loose`;
    triangulation, the merge and the guided bridge read `strict`."""

    feat_a: torch.Tensor
    feat_b: torch.Tensor
    strict: torch.Tensor
    loose: Optional[torch.Tensor]


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
) -> Tuple[ReconstructionState, bool, int, int]:
    """PnP-register `new_view` from 2D-3D correspondences through the track
    table, reading the epipolar-prefiltered loose table `valid_tab`.
    Returns (state, ok, n_inliers, n_support) as host values
    (`register_view_blind` also says whether a failed pick was blind)."""
    state, ok, n_in, n_support, _ = register_view_blind(
        key, state, new_view, done_views, feat_tab_a, feat_tab_b, valid_tab, keypoints_xy,
        K, dist, image_max_dim, config, valid_tab_strict=valid_tab_strict,
    )
    return state, ok, n_in, n_support


def register_view_blind(
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
    retry_failed: bool = False,
) -> Tuple[ReconstructionState, bool, int, int, bool]:
    """`register_view`, also returning whether its pick failed blind.

    A departure from the reference. The reference's RANSAC prescores its
    hypotheses on the first `PRESCORE_ROWS` (256) valid rows, and
    registration orders its loose-only rows first, so where more than 256
    of those exist the
    prescore sees few strict rows or none. Where it sees fewer than a pick
    needs to pass (`pnp_min_inliers`) the pick is blind: every hypothesis
    the prescore keeps may be wrong, and the pick fails on a few inliers
    or passes bent on a few dozen. A blind pick that passes with under
    half the strict rows as inliers, or (with `retry_failed`) fails, is
    selected again from the same key and hypotheses with the strict rows
    prescored first (`solve_pnp_ransac(prescore_strict_first=True)`); the
    new pick is taken where it passes with at least half the strict rows
    as inliers. Every other pick is the reference's, bit for bit. One host
    read serves the check and the counts returned."""
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
    sample = keep & strict_s
    pnp_args = (key, X, px, xn, keep, K)
    pnp_kw = dict(
        threshold_px=g.pnp_threshold_factor * image_max_dim,
        n_hypotheses=g.pnp_ransac_iters, max_translation=g.pnp_max_translation,
        min_inliers=g.pnp_min_inliers, sample_mask=sample,
    )
    res = solve_pnp_ransac(*pnp_args, **pnp_kw)
    ok, n_in, n_support, n_strict, n_strict_in = torch.stack([
        res.ok.to(torch.int64), res.n_inliers.to(torch.int64), torch.sum(keep),
        torch.sum(sample), torch.sum(res.inliers & sample),
    ]).tolist()
    # Strict rows among the prescore's first valid rows: the valid rows
    # there less the loose-only rows, which come first.
    seen = min(n_support, PRESCORE_ROWS, X.shape[0]) - (n_support - n_strict)
    blind = seen < g.pnp_min_inliers
    if blind and ((ok and 2 * n_strict_in < n_strict) or (not ok and retry_failed)):
        alt = solve_pnp_ransac(*pnp_args, prescore_strict_first=True, **pnp_kw)
        alt_ok, alt_in, alt_strict_in = torch.stack([
            alt.ok.to(torch.int64), alt.n_inliers.to(torch.int64), torch.sum(alt.inliers & sample),
        ]).tolist()
        profiling.count("pnp_reselected")
        if alt_ok and 2 * alt_strict_in >= n_strict:
            profiling.count("pnp_reselect_taken")
            log.info(
                "view %d: blind PnP pick (%s, %d inliers) reselected: %d inliers, %d of %d strict rows",
                new_view, "passed" if ok else "failed", n_in, alt_in, alt_strict_in, n_strict,
            )
            res, ok, n_in = alt, alt_ok, alt_in
    cameras = state.cameras.clone()
    camera_valid = state.camera_valid.clone()
    cameras[new_view] = torch.where(
        res.ok, torch.cat([log_so3(res.R), res.t]), cameras[new_view]
    )
    camera_valid[new_view] = camera_valid[new_view] | res.ok
    state = dataclasses.replace(state, cameras=cameras, camera_valid=camera_valid)
    return state, bool(ok), n_in, n_support, bool(blind and not ok)


def triangulate_new_view(
    state: ReconstructionState,
    new_view: torch.Tensor,
    done_view: torch.Tensor,
    feat_tab_a: torch.Tensor,
    feat_tab_b: torch.Tensor,
    valid_tab: torch.Tensor,
    keypoints_xy: torch.Tensor,
    colors: torch.Tensor,
    K: torch.Tensor,
    dist: torch.Tensor,
    config: PipelineConfig,
) -> ReconstructionState:
    """Triangulate the matches (new_view, done_view) of the oriented tables
    with the current poses and merge them into the cloud. The two views are
    (1,) long tensors on the state's device: every per-pair index is a
    gather, so the step reads nothing back to the host and is the body of
    the per-pair CUDA graph (`_TriangulateGraph`)."""
    feat_new = feat_tab_a[new_view, done_view][0]
    feat_done = feat_tab_b[new_view, done_view][0]
    cam_n = state.cameras[new_view][0]
    cam_d = state.cameras[done_view][0]
    pn = keypoints_xy[new_view, feat_new.long()]
    pd = keypoints_xy[done_view, feat_done.long()]
    X, keep = triangulate_and_filter(
        exp_so3(cam_n[:3]), cam_n[3:], exp_so3(cam_d[:3]), cam_d[3:],
        undistort_points(pn, K, dist), undistort_points(pd, K, dist), pn, pd, K,
        valid_tab[new_view, done_view][0] & state.camera_valid[new_view]
        & state.camera_valid[done_view],
        max_error_px=config.geometry.max_reprojection_error_px,
    )
    return add_points(
        state, X, colors[new_view, feat_new.long()], new_view, feat_new,
        done_view, feat_done, keep, merge_distance=config.geometry.merge_distance,
    )


# The fields of the state a pair step writes.
_POINT_FIELDS = (
    "points_xyz", "points_rgb", "points_valid", "track_feat", "feat_to_point", "n_points",
)


class _TriangulateGraph:
    """`triangulate_new_view` captured as one CUDA graph at one shape. The
    graph reads the pair from a static (2,) index buffer, the poses, tables,
    keypoints, colours, K and dist from static copies, and the point fields
    from static buffers; it ends by copying its new point fields into those
    same buffers, so consecutive replays chain the state on the device with
    no host work between pairs. A call copies its inputs in once, replays
    once per done view and clones the point fields out, since the pipeline
    keeps snapshots of states. A replay runs the eager step's kernels in the
    same order on the same values, so the state is the eager loop's bit for
    bit."""

    def __init__(self, state: ReconstructionState, inputs, config: PipelineConfig):
        dev = state.device
        self.views = torch.arange(state.n_views, device=dev)
        self.pair = torch.zeros(2, dtype=torch.long, device=dev)
        self.points = {f: torch.empty_like(getattr(state, f)) for f in _POINT_FIELDS}
        self.inputs = [torch.empty_like(a, memory_format=torch.contiguous_format) for a in inputs]
        cameras, camera_valid, *tables = self.inputs
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            st = dataclasses.replace(
                state, cameras=cameras, camera_valid=camera_valid, **self.points
            )
            st = triangulate_new_view(st, self.pair[0:1], self.pair[1:2], *tables, config)
            for f, buf in self.points.items():
                buf.copy_(getattr(st, f))
        profiling.count("triangulate_graph_captures")

    def __call__(self, state: ReconstructionState, new_view: int, done_views, inputs):
        for f, buf in self.points.items():
            buf.copy_(getattr(state, f))
        for buf, a in zip(self.inputs, inputs):
            buf.copy_(a)
        self.pair[0:1].copy_(self.views[new_view:new_view + 1])
        for d in done_views:
            d = int(d)
            self.pair[1:2].copy_(self.views[d:d + 1])
            self.graph.replay()
        profiling.count("triangulate_graph_replays", len(done_views))
        return dataclasses.replace(state, **{f: buf.clone() for f, buf in self.points.items()})


# The pair step's shapes of this process, the most recently used last: a
# captured graph, or None for a shape seen once (`utils/cuda_graphs.py`).
_TRIANGULATE_GRAPHS: "OrderedDict[tuple, Optional[_TriangulateGraph]]" = OrderedDict()
_TRIANGULATE_GRAPHS_KEPT = 4


def _triangulate_eager(state, new_view, done_views, inputs, config):
    """The pair steps one after another, each dispatched op by op."""
    views = torch.arange(state.n_views, device=state.device)
    for d in done_views:
        d = int(d)
        state = triangulate_new_view(
            state, views[new_view:new_view + 1], views[d:d + 1], *inputs, config
        )
    return state


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
) -> ReconstructionState:
    """Triangulate the new view against every done view, in order. On the
    card a pair step is some 700 small ops whose host dispatch is their
    whole cost, so from a shape's second call on every pair replays one
    CUDA graph (`_TriangulateGraph`, one per shape and per the two config
    values the step reads); a shape's first call, and every call on the
    CPU, runs the steps eagerly."""
    tables = (feat_tab_a, feat_tab_b, valid_tab, keypoints_xy, colors, K, dist)
    with profiling.span("triangulate", done_views=len(done_views)):
        if state.device.type != "cuda":
            return _triangulate_eager(state, new_view, done_views, tables, config)
        inputs = (state.cameras, state.camera_valid, *tables)
        g = config.geometry
        key = (
            state.capacity, state.n_views, state.max_keypoints, feat_tab_a.shape[-1],
            tuple(a.dtype for a in inputs), state.device.index,
            g.max_reprojection_error_px, g.merge_distance,
        )
        with torch.cuda.device(state.device):
            graph = cached_graph(
                _TRIANGULATE_GRAPHS, _TRIANGULATE_GRAPHS_KEPT, key,
                lambda: _TriangulateGraph(state, inputs, config),
            )
            if graph is None:
                return _triangulate_eager(state, new_view, done_views, tables, config)
            return graph(state, new_view, done_views, inputs)


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
    retry_failed: bool = False,
) -> Tuple[ReconstructionState, Tuple[int, int, int, int, int, int]]:
    """PnP registration (`register_view_blind`) and, when it succeeds,
    triangulation against every done view (strict table). Returns (state,
    (ok, n_inliers, n_support, n_points, n_obs, failed_blind)) as host
    ints."""
    profiling.count("pnp_attempts")
    with profiling.span("pnp", view=new_view, done_views=len(done_views)) as sp:
        state, ok, n_inl, n_support, failed_blind = register_view_blind(
            key, state, new_view, done_views, feat_tab_a, feat_tab_b, valid_tab_loose,
            keypoints_xy, K, dist, image_max_dim, config, valid_tab_strict=valid_tab_strict,
            retry_failed=retry_failed,
        )
    profiling.annotate(sp, ok=ok)
    profiling.count("pnp_failed", int(not ok))
    if ok:
        state = triangulate_new_view_all(
            state, new_view, done_views, feat_tab_a, feat_tab_b, valid_tab_strict,
            keypoints_xy, colors, K, dist, config,
        )
    n_obs = torch.sum(live_observations(state))
    return state, (
        int(ok), n_inl, n_support, int(state.n_points), int(n_obs), int(failed_blind)
    )
