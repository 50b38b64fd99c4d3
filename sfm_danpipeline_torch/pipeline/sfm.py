"""End-to-end incremental SfM orchestrator (sparse stage).

Port of the default path of sfm_danpipeline_tpu/pipeline/sfm.py
`SfMPipeline.run` (`StructFromMotion::map3D`, src/Sfm.cpp:9-109): SIFT ->
all-pairs matching (the hand-written CUDA kNN kernel on a card) -> pair
scoring + epipolar prefilter -> validated seed bootstrap -> incremental
PnP + triangulation + per-view BA -> secondary components, each merged
into the main one by a gated Sim(3) -> straggler sweep -> rotation-
averaging reinit (at >= ba.rotavg_min_views views) and the final global
BA.

The detector (SIFT, AKAZE, ORB) and the matcher (descriptor kNN or LK flow)
follow the config; with a `checkpoint_path` the state is saved after every
registered view and accepted merge, and `run` resumes from the file. With
`geometry.guided_enable` a view that fails PnP is retried by guided bridge
registration (pipeline/guided.py), and the block of views registered from
the first guided success on is re-verified by a Sim(3) block realign before
the final BA. With more than one shard device, matching and the final BA are
sharded (parallel/matching.py, ba/sharded.py); `run` also takes precomputed
keypoints and matches (the multi-process driver, parallel/distributed.py).

The reference's fixed-capacity buckets and fused-dispatch packaging are
TPU workarounds and are not ported: BA works on the exact observation
table, and each step runs as eager torch ops.

RANSAC draws come from the reference's threefry key tree (ops/prng.py),
split and consumed at the same places under the same conditions, so one
seed gives the reference's samples on the CPU and on a card: the root key
splits into a scoring and a registration key, the prefilter takes the
root folded with 0x9E1F, and every seed attempt, registration, guided
attempt, merge and block realign takes the next of V*32 registration keys
(`SetProgress.next_key`).

The steps (`register_adjust_step`, `merge_attempt_step`, the pipeline's
methods) read one set's inputs whole (`SetInputs`) and what it changes as it
runs from one `SetProgress`; the lower layers (pipeline/incremental.py,
bootstrap.py, merge.py, guided.py) keep the reference's signatures.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sfm_danpipeline_torch import require_device
from sfm_danpipeline_torch.ba.problem import BAProblem
from sfm_danpipeline_torch.ba.sharded import run_ba_sharded
from sfm_danpipeline_torch.ba.solver import run_ba
from sfm_danpipeline_torch.config import PipelineConfig
from sfm_danpipeline_torch.io.calibration import Intrinsics
from sfm_danpipeline_torch.io.images import ImageBatch
from sfm_danpipeline_torch.ops import prng
from sfm_danpipeline_torch.ops.akaze import detect_and_compute_akaze_batch
from sfm_danpipeline_torch.ops.flow import flow_match_all_pairs
from sfm_danpipeline_torch.ops.interp import bilinear_sample
from sfm_danpipeline_torch.ops.lie import exp_so3, log_so3
from sfm_danpipeline_torch.ops.matching import PairMatches, match_all_pairs
from sfm_danpipeline_torch.ops.orb import detect_and_compute_orb_batch
from sfm_danpipeline_torch.ops.projection import undistort_points
from sfm_danpipeline_torch.ops.rotavg import (
    average_rotations,
    average_translations,
    project_so3,
)
from sfm_danpipeline_torch.ops.select import top_k_indices
from sfm_danpipeline_torch.ops.sift import Keypoints, detect_and_compute_batch
from sfm_danpipeline_torch.ops.similarity import estimate_sim3_reproj_ransac
from sfm_danpipeline_torch.parallel.matching import match_all_pairs_sharded
from sfm_danpipeline_torch.pipeline.bootstrap import (
    PairScores,
    bootstrap_pair,
    score_pairs,
)
from sfm_danpipeline_torch.pipeline.guided import guided_bridge_register
from sfm_danpipeline_torch.pipeline.incremental import (
    MatchTables,
    build_match_tables,
    epipolar_prefilter_table,
    register_and_triangulate,
    triangulate_new_view_all,
)
from sfm_danpipeline_torch.pipeline.merge import (
    block_realign,
    cross_component_pairs,
    merge_components,
    views_reprojection_median,
)
from sfm_danpipeline_torch.pipeline.tracks import (
    ReconstructionState,
    init_state,
    live_observations,
    observation_table_compact,
    prune_observations,
    retriangulate_points,
)
from sfm_danpipeline_torch.utils import profiling
from sfm_danpipeline_torch.utils.checkpoint import load_state, save_state

log = logging.getLogger("sfm_danpipeline_torch")

def _k_matrix(focal: torch.Tensor, pp: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(focal)
    o = torch.ones_like(focal)
    return torch.stack(
        [torch.stack([focal, z, pp[0]]), torch.stack([z, focal, pp[1]]), torch.stack([z, z, o])]
    )


@dataclasses.dataclass(frozen=True)
class SetInputs:
    """What every step of one set reads and none writes, made once by
    `SfMPipeline.run` when the match tables and pair scores exist. The
    step functions read the first eight fields; the rest only
    `SfMPipeline`'s seed search, component growth, guided bridge and
    reinit."""

    config: PipelineConfig
    kp: Keypoints  # xy canonicalized to ideal pixels where the lens distorts
    colors: torch.Tensor  # (V, K, 3) RGB sampled at the raw detections
    K: torch.Tensor
    dist: torch.Tensor  # zeros once the keypoints are canonicalized
    pp: torch.Tensor  # (2,) principal point
    max_dim: float  # the longer image side, px
    tables: MatchTables
    image_size: Optional[Tuple[int, int]] = None
    strict: Optional[PairMatches] = None  # the ratio test's matches, in pair order
    scores: Optional[PairScores] = None  # pair scoring on `strict`
    pair_of: Optional[Dict[Tuple[int, int], int]] = None  # (i, j), i < j -> pair, in pair order
    focal: Optional[float] = None  # a seed state's initial focal length, px
    run_ba_every_view: bool = True

    @property
    def n_views(self) -> int:
        return self.kp.xy.shape[0]


@dataclasses.dataclass
class SetProgress:
    """What one set changes as it runs, beside its reconstruction states."""

    keys: torch.Tensor  # the V * 32 registration keys
    key_n: int = 0  # keys taken; a checkpoint carries it
    lost: set = dataclasses.field(default_factory=set)  # views of components whose merge failed
    failed_blind: set = dataclasses.field(default_factory=set)  # views whose last PnP pick failed blind
    # The main component's views registered from its first guided success on.
    guided_block: List[int] = dataclasses.field(default_factory=list)
    n_guided_registered: int = 0

    def next_key(self) -> torch.Tensor:
        """The next registration key, `keys[key_n % len(keys)]`, as the
        reference takes it."""
        key = self.keys[self.key_n % len(self.keys)]
        self.key_n += 1
        return key


def ba_step(
    state: ReconstructionState,
    keypoints_xy: torch.Tensor,
    pp: torch.Tensor,
    fix_cam: torch.Tensor,
    config: PipelineConfig,
    max_iterations: int,
    local_view: Optional[int] = None,
    shard_devices: Optional[Sequence[torch.device]] = None,
):
    """Bundle adjustment + map hygiene on the exact observation table.

    `local_view` selects local-window BA: only that view and its
    (local_window - 1) most covisible registered cameras move, the other
    cameras are frozen. Every point moves: the reference builds a
    point-freezing mask for the window but its LM loop rebuilds the problem
    without it (sfm_danpipeline_tpu/ba/solver.py run_ba), so this is what it
    computes. `shard_devices` runs the solve observation-sharded over those
    devices (ba/sharded.py; the reference's `_ba_final_sharded`). Returns
    (state, initial_cost, final_cost, iterations, n_obs)."""
    ba_cfg = config.ba
    B = int(state.n_points)  # points occupy slots [0, n_points)
    V = state.n_views
    obs_cam, obs_pt, xy, w = observation_table_compact(state, keypoints_xy, pp, n_points=B)
    fix_cam_eff = fix_cam
    if local_view is not None:
        has = state.track_feat[:B] >= 0
        pt_local = has[:, local_view] & state.points_valid[:B]
        shared = torch.sum(has & pt_local[:, None], dim=0)
        shared = torch.where(state.camera_valid, shared, torch.full_like(shared, -1))
        # top_k tie order matters for which equally covisible camera
        # joins the window (ops/select.py).
        topv = top_k_indices(shared, min(ba_cfg.local_window, V))
        active = torch.zeros((V,), dtype=torch.bool, device=shared.device)
        active[topv] = True
        active[local_view] = True
        fix_cam_eff = fix_cam | ~(active & state.camera_valid)
    prob = BAProblem(
        cameras=state.cameras, focal=state.focal, points=state.points_xyz[:B],
        obs_cam=obs_cam, obs_pt=obs_pt, obs_xy=xy, obs_w=w, fix_cam=fix_cam_eff,
        fix_focal=torch.tensor(not ba_cfg.optimize_focal, device=pp.device),
    )
    with profiling.span(
        "ba", points=B, max_iterations=int(max_iterations), local=local_view is not None,
        sharded=shard_devices is not None,
    ) as sp:
        if shard_devices is None:
            res = run_ba(prob, ba_cfg, max_iterations=max_iterations)
        else:
            res = run_ba_sharded(prob, ba_cfg, shard_devices, max_iterations=max_iterations)
        points = state.points_xyz.clone()
        points[:B] = res.points
        state = dataclasses.replace(state, cameras=res.cameras, focal=res.focal, points_xyz=points)
        state = prune_observations(
            state, keypoints_xy, _k_matrix(state.focal, pp),
            max_error_px=config.geometry.max_reprojection_error_px,
        )
    profiling.annotate(sp, iterations=res.iterations)
    profiling.count("ba_solves")
    profiling.count("lm_iterations", res.iterations)
    return state, res.initial_cost, res.final_cost, res.iterations, torch.sum(w)


def register_adjust_step(
    key, state, new_view: int, done_views, inputs: SetInputs, fix_cam,
    local_view: Optional[int], run_ba: bool = True, retry_failed: bool = False,
):
    """PnP register + triangulate + (when registration succeeds) the
    per-view BA, local-window when `local_view` is set. `retry_failed` is
    `register_view_blind`'s. Returns (state, (ok, n_inliers, n_support, n_points,
    n_obs, failed_blind))."""
    cfg, t, xy = inputs.config, inputs.tables, inputs.kp.xy
    state, stats = register_and_triangulate(
        key, state, new_view, done_views, t.feat_a, t.feat_b, t.loose, t.strict,
        xy, inputs.colors, inputs.K, inputs.dist, inputs.max_dim, cfg, retry_failed=retry_failed,
    )
    if stats[0] and run_ba:
        state = ba_step(
            state, xy, inputs.pp, fix_cam, cfg, cfg.ba.intermediate_iterations, local_view=local_view,
        )[0]
        stats = stats[:4] + (int(torch.sum(live_observations(state))),) + stats[5:]
    return state, stats


def merge_attempt_step(
    key, state_a: ReconstructionState, state_b: ReconstructionState,
    b_views: Sequence[int], a_views: Sequence[int], inputs: SetInputs, fix_cam,
    samples: Optional[torch.Tensor] = None,
):
    """One Sim(3) merge attempt of component B into A: cross-component
    3D-3D candidates from the strict matches -> reprojection-scored Sim(3)
    RANSAC -> merge and gate 1 (median cross-track reprojection in B's
    views <= max_merge_reprojection_px) -> triangulation of every B view
    against A's views -> an intermediate BA -> gate 2 (that median <= half
    the bound). Any failure keeps A. `samples` injects the RANSAC draws.

    Returns (state, stats) with stats = {accepted, sim_ok, n_sim_inliers,
    med_gate1_px, med_gate2_px, n_cross_tracks, scale}."""
    with profiling.span("merge") as sp:
        config, t, keypoints_xy, pp = inputs.config, inputs.tables, inputs.kp.xy, inputs.pp
        V = state_a.n_views
        bound = config.geometry.max_merge_reprojection_px
        K_cur = _k_matrix(state_a.focal, pp)
        b_mask = torch.zeros((V,), dtype=torch.bool, device=pp.device)
        b_mask[list(b_views)] = True
        Xa, Xb, pid_a, pid_b, va, fa, m = cross_component_pairs(
            state_a, state_b, t.feat_a, t.feat_b, t.strict
        )
        sim = estimate_sim3_reproj_ransac(
            key, Xb, Xa, state_a.cameras[va], keypoints_xy[va, fa], K_cur, m,
            threshold_px=0.75 * bound, n_hypotheses=16384, min_inliers=8,
            samples=samples,
        )

        def cross_med(st):
            has_obs = st.track_feat >= 0
            seen_b = torch.any(has_obs & b_mask[None, :], dim=1)
            seen_a = torch.any(has_obs & (~b_mask & st.camera_valid)[None, :], dim=1)
            cross = seen_a & seen_b & st.points_valid
            med = views_reprojection_median(st, b_mask, keypoints_xy, K_cur, points_mask=cross)
            return med, int(torch.sum(cross))

        sim_ok = bool(sim.ok)
        med1 = med2 = float("inf")
        n_cross = 0
        cand = state_a
        if sim_ok:
            cand = merge_components(state_a, state_b, sim.sim, pid_a, pid_b, sim.inliers)
            med1, _ = cross_med(cand)
            if med1 <= bound:
                for v in sorted(b_views):
                    cand = triangulate_new_view_all(
                        cand, v, a_views, t.feat_a, t.feat_b, t.strict, keypoints_xy,
                        inputs.colors, inputs.K, inputs.dist, config,
                    )
                cand = ba_step(
                    cand, keypoints_xy, pp, fix_cam, config, config.ba.intermediate_iterations
                )[0]
                med2, n_cross = cross_med(cand)
        accepted = sim_ok and med1 <= bound and med2 <= 0.5 * bound
        stats = dict(
            accepted=accepted, sim_ok=sim_ok, n_sim_inliers=int(sim.n_inliers),
            med_gate1_px=med1, med_gate2_px=med2, n_cross_tracks=n_cross,
            scale=float(sim.sim.s),
        )
    profiling.annotate(sp, n_sim_inliers=stats["n_sim_inliers"], accepted=accepted)
    return (cand if accepted else state_a), stats


@dataclasses.dataclass
class SfMResult:
    state: ReconstructionState
    keypoints: Keypoints
    points: np.ndarray  # (N, 3) valid points
    colors: np.ndarray  # (N, 3)
    registered_views: List[int]
    metrics: Dict[str, float]
    # Baseline-pair match endpoints (xy_a, xy_b, valid) for visualization.
    baseline_matches: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    # Raw detected keypoint positions when distortion canonicalized them.
    raw_xy: Optional[np.ndarray] = None
    # The run's trace (utils/profiling.py StageTimer.trace): spans, counters.
    trace: Optional[dict] = None


def _keypoint_colors(color: torch.Tensor, kp: Keypoints) -> torch.Tensor:
    """Per-keypoint RGB samples (V, K, 3) from color images (V, H, W, 3)."""
    return torch.stack(
        [
            torch.stack(
                [bilinear_sample(color[v, ..., c], kp.xy[v, :, 0], kp.xy[v, :, 1]) for c in range(3)],
                dim=-1,
            )
            for v in range(color.shape[0])
        ]
    )


def _pair_list(n: int) -> Tuple[List[int], List[int]]:
    """All i<j pairs in the reference's loop order (src/Sfm.cpp:511-512)."""
    pi, pj = [], []
    for i in range(n - 1):
        for j in range(i + 1, n):
            pi.append(i)
            pj.append(j)
    return pi, pj


class SfMPipeline:
    """Host-side orchestrator. Usage:

        pipe = SfMPipeline(config)
        result = pipe.run(images, intrinsics)

    Runs on the CUDA card unless the caller asks for `device="cpu"`; with no
    card present the default raises instead of running on the CPU."""

    def __init__(
        self,
        config: PipelineConfig = PipelineConfig(),
        checkpoint_path: Optional[str] = None,
        device: str | torch.device = "cuda",
        shard_devices: Optional[Sequence[str | torch.device]] = None,
    ):
        """`checkpoint_path`: when set, the reconstruction state is saved
        after every registered view and accepted merge (one small .npz), and
        `run` resumes from the file if it exists. `shard_devices`: the
        devices of the sharded paths, `device` first (default: `device` and
        every other local card; just `device` on the CPU). With more than one,
        matching is pair-sharded when there are at least as many pairs, and
        the final global BA is observation-sharded from
        `ba.sharded_min_obs` observations on, as in the reference."""
        self.config = config
        self.checkpoint_path = checkpoint_path
        self.device = require_device(device)
        if shard_devices is None:
            shard_devices = [self.device]
            if self.device.type == "cuda":
                home = self.device.index if self.device.index is not None else torch.cuda.current_device()
                shard_devices += [
                    torch.device("cuda", i) for i in range(torch.cuda.device_count()) if i != home
                ]
        self.shard_devices = [torch.device(d) for d in shard_devices]

    def _sync(self) -> None:
        """Wait for queued device work so host timers read true stage times."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _stage(self, trace, metrics: Dict[str, float], name: str):
        """The stage span `name`, ended after a synchronize; its duration
        is metrics["t_<name>"]."""
        with trace.span(name) as sp:
            yield
            self._sync()
        metrics["t_" + name] = profiling.span_seconds(sp)

    def _check_config(self) -> None:
        cfg = self.config
        if cfg.features.detector not in ("sift", "akaze", "orb"):
            raise ValueError(f"unknown detector {cfg.features.detector!r}")
        if cfg.matching.method not in ("bf", "flow"):
            raise ValueError(f"unknown matching method {cfg.matching.method!r}")

    def _save_ckpt(self, state, done: set, anchor: int) -> None:
        if not self.checkpoint_path:
            return
        save_state(
            self.checkpoint_path, state,
            done=np.asarray(sorted(done), np.int32),
            lost=np.asarray(sorted(self._progress.lost), np.int32),
            anchor=np.asarray(anchor, np.int32),
            # Beyond the reference's extras: the registration key counter,
            # so that a resumed run draws the RANSAC samples the
            # uninterrupted one would (the reference restarts it at 0).
            key_n=np.asarray(self._progress.key_n, np.int64),
        )

    def _load_ckpt(self, V: int):
        """Returns (state, done, lost, anchor, key_n) or None; key_n is the
        registration key counter. A checkpoint without the counter is
        refused: resuming it would draw other samples than the run that
        wrote it."""
        if not (self.checkpoint_path and os.path.exists(self.checkpoint_path)):
            return None
        st, extra = load_state(self.checkpoint_path, device=self.device)
        cfg = self.config
        if tuple(st.track_feat.shape) != (cfg.max_points, V) or (
            st.max_keypoints != cfg.features.max_keypoints
        ):
            log.warning(
                "checkpoint %s has incompatible shapes — ignoring", self.checkpoint_path
            )
            return None
        if "done" not in extra:
            return None
        if "key_n" not in extra:
            raise ValueError(
                f"checkpoint {self.checkpoint_path} has no `key_n` (the RANSAC key "
                "counter); a resumed run cannot draw the samples of the run that "
                "wrote it, so it is refused"
            )
        return (
            st,
            set(np.asarray(extra["done"]).tolist()),
            set(np.asarray(extra.get("lost", np.zeros(0))).tolist()),
            int(extra.get("anchor", 0)),
            int(extra["key_n"]),
        )

    # ------------------------------------------------------------------
    def run(
        self,
        images: ImageBatch,
        intrinsics: Intrinsics,
        run_ba_every_view: bool = True,
        precomputed_keypoints: Optional[Keypoints] = None,
        precomputed_matches=None,
        precomputed_canonical: bool = False,
        precomputed_raw_xy=None,
    ) -> SfMResult:
        """`precomputed_keypoints` / `precomputed_matches` skip the feature
        and matching stages: the injection point of the multi-process driver
        (parallel/distributed.run_sfm_multihost), whose ranks compute their
        image and pair blocks and gather them. `precomputed_matches` must be
        the loose-ratio PairMatches over `_pair_list(V)` order.
        `precomputed_canonical=True` states that the keypoints' xy are already
        ideal pinhole pixels (the caller undistorted them), so they are not
        undistorted again; `precomputed_raw_xy` carries the raw detections.

        The run is traced (utils/profiling.py): a root span "set", the stage
        spans "features", "matching", "baseline", "incremental",
        "components" and "final_ba" (each ended after a synchronize; the
        `t_*` metrics are their durations), and the spans and counters of
        the steps under them. The trace is the result's `trace` and joins
        profiling's record of recent runs; a run that raises records
        nothing."""
        with profiling.recording() as trace:
            with trace.span("set"):
                res = self._run(
                    trace, images, intrinsics, run_ba_every_view, precomputed_keypoints,
                    precomputed_matches, precomputed_canonical, precomputed_raw_xy,
                )
        res.trace = trace.trace()
        return res

    def _run(
        self, trace, images, intrinsics, run_ba_every_view, precomputed_keypoints,
        precomputed_matches, precomputed_canonical, precomputed_raw_xy,
    ) -> SfMResult:
        self._check_config()
        cfg = self.config
        dev = self.device
        t_start = time.time()
        metrics: Dict[str, float] = {}
        stage = functools.partial(self._stage, trace, metrics)
        V = images.n_images
        K = torch.as_tensor(intrinsics.K, dtype=torch.float32, device=dev)
        dist = torch.as_tensor(intrinsics.dist, dtype=torch.float32, device=dev)
        pp = torch.tensor([intrinsics.cx, intrinsics.cy], dtype=torch.float32, device=dev)
        max_dim = float(max(images.shape))
        # The reference's key tree (its sfm.py run): scoring and registration
        # keys split from the root, the prefilter's folded in. The batched
        # pair draws hash their words on the card; a registration's few
        # thousand draws cost less host time hashed on the host and copied
        # (PERF.md section 5), so the registration keys stay there.
        root = prng.key(cfg.geometry.seed)
        k_score, k_reg = prng.split(root, 2).unbind(0)
        k_pref = prng.fold_in(root, 0x9E1F)
        run = self._progress = SetProgress(keys=prng.split(k_reg, V * 32))

        # 1. Features (src/Sfm.cpp:257-327), the whole batch at once.
        with stage("features"):
            gray = torch.as_tensor(images.gray, device=dev)
            if precomputed_keypoints is not None:
                kp = Keypoints(
                    *(getattr(precomputed_keypoints, f.name).to(dev)
                      for f in dataclasses.fields(Keypoints))
                )
            elif cfg.features.detector == "orb":
                kp = detect_and_compute_orb_batch(gray, max_keypoints=cfg.features.max_keypoints)
            elif cfg.features.detector == "akaze":
                kp = detect_and_compute_akaze_batch(gray, cfg.features)
            else:
                kp = detect_and_compute_batch(gray, cfg.features)
        metrics["n_keypoints_mean"] = float(kp.valid.sum(-1).float().mean())
        log.info(
            "features: %.2fs, mean %d kp/image",
            metrics["t_features"], metrics["n_keypoints_mean"],
        )
        colors = _keypoint_colors(torch.as_tensor(images.color, device=dev), kp)

        # Lens-distortion canonicalization: undistort every keypoint once
        # into ideal pinhole pixels; the rest of the pipeline then runs
        # distortion-free. Colors were sampled at the raw detections.
        raw_xy = None
        if precomputed_canonical:
            raw_xy = precomputed_raw_xy
            if bool(np.any(np.asarray(intrinsics.dist) != 0.0)):
                dist = torch.zeros_like(dist)
        elif bool(np.any(np.asarray(intrinsics.dist) != 0.0)):
            raw_xy = kp.xy.cpu().numpy()
            xn = undistort_points(kp.xy, K, dist)
            ideal = torch.stack(
                [xn[..., 0] * K[0, 0] + K[0, 2], xn[..., 1] * K[1, 1] + K[1, 2]], dim=-1
            )
            kp = dataclasses.replace(kp, xy=ideal)
            dist = torch.zeros_like(dist)
            log.info("distortion: keypoints canonicalized to ideal pixels")

        # 2. All-pairs matching (src/Sfm.cpp:509-583): one pass at the
        # loose registration ratio; the strict reference set is a mask.
        # "flow" selects the LK alternative (src/Sfm.cpp:1399), which
        # carries no Lowe ratio and launches no kNN kernel.
        with stage("matching"):
            pi, pj = _pair_list(V)
            pi_t = torch.tensor(pi, dtype=torch.int32, device=dev)
            pj_t = torch.tensor(pj, dtype=torch.int32, device=dev)
            if precomputed_matches is not None:
                matches = PairMatches(
                    *(getattr(precomputed_matches, f.name).to(dev)
                      for f in dataclasses.fields(PairMatches))
                )
            elif cfg.matching.method == "flow":
                matches = flow_match_all_pairs(
                    gray, kp.xy, kp.valid, pi, pj, radius=cfg.matching.flow_radius,
                    max_matches=cfg.matching.max_matches,
                )
            else:
                # With more than one device the pair list is block-sharded over
                # them (parallel/matching.py), as the reference does over its
                # local devices.
                loose = max(cfg.matching.ratio, cfg.matching.registration_ratio)
                kw = dict(
                    ratio=loose, max_matches=cfg.matching.max_matches,
                    strict_ratio=cfg.matching.ratio, xy=kp.xy,
                    dup_radius=cfg.matching.dup_radius, dedup=cfg.matching.dedup_matches,
                )
                n_dev = len(self.shard_devices)
                if n_dev > 1 and len(pi) >= n_dev:
                    matches = match_all_pairs_sharded(
                        kp.descriptors, kp.valid, pi_t, pj_t, devices=self.shard_devices, **kw
                    )
                else:
                    matches = match_all_pairs(kp.descriptors, kp.valid, pi_t, pj_t, **kw)
        metrics["n_pairs"] = len(pi)
        log.info("matching: %.2fs over %d pairs", metrics["t_matching"], len(pi))

        # 3. Pair scoring + baseline (src/Sfm.cpp:408-489) on the strict set,
        # and the all-pairs epipolar prefilter of the loose set, each from
        # its own key.
        strict = matches.at_ratio(cfg.matching.ratio)
        with stage("baseline"):
            with trace.span("baseline.score"):
                k_score, k_pref = k_score.to(dev), k_pref.to(dev)
                scores = score_pairs(k_score, strict, kp.xy, pi, pj, K, dist, max_dim, cfg)
                vt_loose = epipolar_prefilter_table(
                    k_pref, matches.idx_a, matches.idx_b, matches.valid, kp.xy, pi, pj,
                    K, dist, cfg, V,
                )
                ft_a, ft_b, _ = build_match_tables(matches, pi, pj, V)
                _, _, vt_strict = build_match_tables(strict, pi, pj, V)
                tables = MatchTables(ft_a, ft_b, vt_strict, vt_loose)
                self._ctx = {"tables": tables}  # read by the benchmark (portbench/program.py)
                inp = self._inputs = SetInputs(
                    config=cfg, kp=kp, colors=colors, K=K, dist=dist, pp=pp, max_dim=max_dim,
                    tables=tables, image_size=tuple(images.shape), strict=strict, scores=scores,
                    pair_of={(a, b): n for n, (a, b) in enumerate(zip(pi, pj))},
                    focal=intrinsics.fx, run_ba_every_view=run_ba_every_view,
                )
                scores_np = scores.pose_inlier_ratio.cpu().numpy()
                usable_np = scores.usable.cpu().numpy()

            def ranked_pairs(allowed):
                cand = [
                    (scores_np[p], a, b) for (a, b), p in inp.pair_of.items()
                    if a in allowed and b in allowed and usable_np[p]
                ]
                return [(a, b) for _, a, b in sorted(cand, reverse=True)]

            resume = self._load_ckpt(V)
            if resume is not None:
                state, done, run.lost, vi, run.key_n = resume
                vj = vi
                baseline_matches = None
                log.info(
                    "resumed from %s: %d views registered, %d lost",
                    self.checkpoint_path, len(done), len(run.lost),
                )
            else:
                seed = self._try_seed(ranked_pairs(set(range(V))), set())
                if seed is None:
                    raise RuntimeError(
                        "baseline reconstruction failed (no seed pair survived "
                        "pose, angle gate, and third-view validation)"
                    )
                state, done, (vi, vj) = seed
                one = strict.pair(inp.pair_of[(vi, vj)])
                baseline_matches = (
                    kp.xy[vi][one.idx_a.long()].cpu().numpy(),
                    kp.xy[vj][one.idx_b.long()].cpu().numpy(),
                    one.valid.cpu().numpy(),
                )
                self._save_ckpt(state, done, vi)
            metrics["baseline_pair_i"] = vi
            metrics["baseline_pair_j"] = vj
        metrics["n_baseline_points"] = int(state.n_points)

        # 4. Incremental loop (src/Sfm.cpp:893-1009): the main component's
        # growth, where a view whose transitive 2D-3D support starves across
        # a viewpoint break is retried by map-projection matching (the
        # guided bridge) before it is left to the secondary components.
        with stage("incremental"):
            state = self._grow_component(state, done, set(), anchor=vi, main=True)

        # 4b. Secondary components + Sim(3) merge: the remaining views
        # bootstrap their own component with the same engine, and each
        # component is merged into the main one by a gated Sim(3)
        # (merge_attempt_step) or its views are lost.
        metrics["n_components"] = 1
        metrics["n_merged_components"] = 0
        lost = run.lost
        with stage("components"):
            while V - len(done) - len(lost) >= 2:
                remaining = set(range(V)) - done - lost
                seed_b = self._try_seed(ranked_pairs(remaining), done | lost)
                if seed_b is None:
                    break
                state_b, done_b, (bi, _) = seed_b
                state_b = self._grow_component(state_b, done_b, done | lost, anchor=bi)
                # Converge the component fully before the Sim(3) attempt.
                state_b, _ = self._run_global_ba(state_b, anchor=bi)
                metrics["n_components"] += 1
                state_m, ms = merge_attempt_step(
                    run.next_key(), state, state_b, sorted(done_b), sorted(done), inp,
                    self._fix_mask(vi),
                )
                if ms["accepted"]:
                    log.info(
                        "merging component %s into main (%d Sim3 inliers, scale "
                        "%.3f, gate1 %.2f px, post-BA gate2 %.2f px over %d cross "
                        "tracks)", sorted(done_b), ms["n_sim_inliers"], ms["scale"],
                        ms["med_gate1_px"], ms["med_gate2_px"], ms["n_cross_tracks"],
                    )
                    state = state_m
                    done = done | done_b
                    metrics["n_merged_components"] += 1
                    metrics["merge_cross_med_px"] = ms["med_gate2_px"]
                    metrics["n_cross_tracks"] = ms["n_cross_tracks"]
                else:
                    if not ms["sim_ok"]:
                        log.warning(
                            "component %s: Sim3 alignment failed (%d inliers) — "
                            "dropping it", sorted(done_b), ms["n_sim_inliers"],
                        )
                    elif ms["med_gate1_px"] > cfg.geometry.max_merge_reprojection_px:
                        log.warning(
                            "component %s: Sim(3) rejected by reprojection gate "
                            "(median %.2f px > %.1f)", sorted(done_b),
                            ms["med_gate1_px"], cfg.geometry.max_merge_reprojection_px,
                        )
                    else:
                        log.warning(
                            "component %s: merge rejected by post-BA cross-track "
                            "gate (median %.2f px)", sorted(done_b), ms["med_gate2_px"],
                        )
                    lost |= done_b  # its views stay unregistered
                self._save_ckpt(state, done, vi)

            # 4c. Straggler sweep: a view that failed PnP against either
            # component alone often registers against the merged cloud. A
            # departure from the reference joins it where at most a quarter
            # of the views are out: a view no component holds whose last
            # pick failed blind (register_view_blind) is swept too, merged
            # or not, and a blind pick that fails in the sweep is selected
            # again. Where more views are out the gaps are more than blind
            # picks (a dropped component, a stretch no pair bridges) and the
            # sweep is the reference's, as it is where no pick failed blind.
            few_out = 4 * (V - len(done)) <= V
            blind = run.failed_blind - done - lost if few_out else set()
            merged = metrics["n_merged_components"] > 0
            exclude_ref = lost if merged else set(range(V)) - done  # the reference's sweep
            if (merged and len(done) + len(lost) < V) or blind:
                n_before = len(done)
                exclude = exclude_ref - blind
                trace.count("blind_views_swept", len(blind & exclude_ref))
                with trace.span("stragglers"):
                    state = self._grow_component(
                        state, done, exclude, anchor=vi, main=True, retry_failed=few_out,
                    )
                trace.count("straggler_views", len(done) - n_before)
                if len(done) > n_before:
                    log.info("straggler sweep registered %d more view(s)", len(done) - n_before)
        metrics["n_guided_registered"] = run.n_guided_registered

        # 5. Final global BA, after a rotation-averaging reinit on large
        # view sets (kept only if the polished result does not regress).
        ba_metrics = None
        with stage("final_ba"):
            # 5a. Guided-block realign: when views crossed a break on guided 2D
            # evidence, re-verify the block's placement by 3D-3D Sim(3)
            # consensus against the rest of the map, with a snapshot-compare
            # revert.
            block = sorted(set(run.guided_block) & done)
            if block and len(block) < len(done):
                b_mask = torch.zeros((V,), dtype=torch.bool, device=dev)
                b_mask[block] = True
                state_ra, ra = block_realign(
                    run.next_key(), state, b_mask, tables.feat_a, tables.feat_b, tables.strict,
                    kp.xy, _k_matrix(state.focal, pp),
                    threshold_px=0.75 * cfg.geometry.max_merge_reprojection_px, n_hypotheses=16384,
                )
                log.info(
                    "block realign %s: ok=%d inliers=%d/%d scale=%.3f", block, ra["ok"],
                    ra["n_inliers"], ra["n_candidates"], ra["scale"],
                )
                if ra["ok"]:
                    state, ba_metrics, applied = self._accept_reinit(state_ra, state, vi, "block realign")
                    metrics["block_realign_applied"] = applied
            if cfg.ba.rotavg_min_views and len(done) >= cfg.ba.rotavg_min_views:
                with trace.span("reinit", n_registered=len(done)) as sp_re:
                    state_ra = self._rotavg_initialize(state, done)
                    applied = 0.0
                    if state_ra is not state:
                        state, ba_metrics, applied = self._accept_reinit(
                            state_ra, state, vi, "rotavg reinit"
                        )
                        metrics["rotavg_applied"] = applied
                    profiling.annotate(sp_re, applied=bool(applied))
                trace.count("reinit_applied", int(applied))
            if ba_metrics is None:
                state, ba_metrics = self._run_global_ba(state, anchor=vi)
            metrics.update(ba_metrics)

        valid = state.points_valid.cpu().numpy()
        pts = state.points_xyz.cpu().numpy()[valid]
        cols = state.points_rgb.cpu().numpy()[valid]
        metrics["n_points"] = int(valid.sum())
        metrics["n_registered"] = len(done)
        metrics["t_total"] = time.time() - t_start
        log.info("done: %d views, %d points, %.2fs total", len(done), int(valid.sum()), metrics["t_total"])
        return SfMResult(
            state=state, keypoints=kp, points=pts, colors=cols,
            registered_views=sorted(done), metrics=metrics,
            baseline_matches=baseline_matches, raw_xy=raw_xy,
        )

    # ------------------------------------------------------------------
    def _fix_mask(self, anchor: int) -> torch.Tensor:
        fix = torch.zeros((self._inputs.n_views,), dtype=torch.bool, device=self.device)
        fix[anchor] = True
        return fix

    def _try_seed(self, seed_pairs, exclude: set, max_attempts: int = 6):
        """Try (seed pair, basin) combinations until one gives a two-view
        reconstruction that a third view PnP-registers against (pairwise
        criteria cannot tell the true epipolar interpretation from the
        low-parallax spurious one; a third view can). Returns
        (state, done_views, (vi, vj)) or None."""
        inp = self._inputs
        cfg = self.config
        V = inp.n_views
        can_validate = V - len(exclude) >= 3
        with profiling.span("seed") as sp:
            for bi, bj in seed_pairs[:max_attempts]:
                bm = inp.strict.pair(inp.pair_of[(bi, bj)])
                for basin in (0, 1):
                    with profiling.span("seed.basin", pair_i=bi, pair_j=bj, basin=basin):
                        st = init_state(
                            V, cfg.features.max_keypoints, cfg.max_points, inp.focal,
                            device=self.device,
                        )
                        profiling.count("seed_basins")
                        # Two-view bootstrap, then the first intermediate BA
                        # where the pose and angle gates accept. (`ok` is read
                        # twice; one read would do, ROADMAP Queue 7.)
                        st, ok, med_ang = bootstrap_pair(
                            self._progress.next_key(), st, bm, inp.kp.xy, inp.colors, bi, bj,
                            inp.K, inp.dist, cfg, basin,
                        )
                        if bool(ok):
                            st = ba_step(
                                st, inp.kp.xy, inp.pp, self._fix_mask(bi), cfg,
                                cfg.ba.intermediate_iterations,
                            )[0]
                        if not bool(ok):
                            log.info(
                                "seed (%d, %d) basin %d rejected (pose/angle gate, "
                                "med angle %.2f deg)", bi, bj, basin, float(med_ang),
                            )
                            continue
                        profiling.count("seed_basins_accepted")
                        done_b = {bi, bj}
                        if not can_validate:
                            profiling.annotate(sp, pair_i=bi, pair_j=bj, basin=basin)
                            return st, done_b, (bi, bj)
                        st2 = self._grow_component(st, done_b, exclude, anchor=bi, max_new_views=1)
                        loop = self._seed_loop_gaps(st2, bi, bj, done_b)
                        if loop is not None and loop[1] < loop[0]:
                            log.warning(
                                "seed (%d, %d) basin %d: its rotation is %.2f deg from the pair's basin "
                                "that the loop through view %s picks and %.2f deg from the other — "
                                "rejecting seed", bi, bj, basin, loop[0], sorted(done_b - {bi, bj}), loop[1],
                            )
                            profiling.count("seeds_loop_rejected")
                            continue
                        if len(done_b) >= 3:
                            log.info(
                                "seed (%d, %d) basin %d validated by view %s (med angle %.2f deg)",
                                bi, bj, basin, sorted(done_b - {bi, bj}), float(med_ang),
                            )
                            profiling.count("seeds_validated")
                            profiling.annotate(sp, pair_i=bi, pair_j=bj, basin=basin)
                            return st2, done_b, (bi, bj)
                        log.warning(
                            "seed (%d, %d) basin %d: no third view registers — rejecting seed",
                            bi, bj, basin,
                        )
        return None

    def _seed_loop_gaps(self, st, bi: int, bj: int, done_b: set) -> Optional[Tuple[float, float]]:
        """For a seed pair validated by one third view w: the angles (deg)
        from the state's relative rotation bi -> bj to the seed pair's two
        scored basins (pair scoring's two-view estimates), first the basin
        that the loop through w picks: the nearer to the rotation composed
        from the better-supported basin (more inliers) of (bi, w) and of
        (w, bj); where a pair's basins tie in support, every such loop must
        pick the same basin. None where no single view validated the seed,
        a pair through w is missing or its better basin holds fewer than
        `min_pair_matches` inliers, or the loops pick apart.

        A departure from the reference, which keeps every seed a third view
        registers against. On the 20-view arc a seed pair's bootstrap can
        land in the spurious epipolar basin (rotation 4.5-6.7 degrees,
        translation 93-105 degrees off) even where pair scoring's better
        basin of the pair is the true one; view 2 registers against it and
        the map drifts to an ATE of 5-16%. There the seed's rotation lies
        nearer the pair's other basin than the one the loop picks, where a
        true seed's lies within a quarter degree of the picked one. The rule
        compares distances and holds no threshold of its own. On the V=6
        courtyard with lens distortion every pair's two basins hold every
        inlier, and the four loops pick apart."""
        scores, pair_of = self._inputs.scores, self._inputs.pair_of
        if len(done_b) != 3 or scores is None:
            return None
        (w,) = sorted(done_b - {bi, bj})
        p_iw, p_wj, p_ij = (pair_of.get((min(a, b), max(a, b))) for a, b in ((bi, w), (w, bj), (bi, bj)))
        if p_iw is None or p_wj is None or p_ij is None:
            return None

        def basins(p, a, b):  # the pair's two basin rotations, camera a -> b
            return scores.R_rel[p] if a < b else scores.R_rel[p].transpose(-1, -2)

        def gap(A, B):  # rotations (..., 3, 3), (..., 3, 3) -> degrees apart
            c = ((A * B).sum((-1, -2)) - 1.0) / 2.0
            return torch.rad2deg(torch.arccos(torch.clamp(c, -1.0, 1.0)))

        n_iw, n_wj = scores.n_inliers[p_iw], scores.n_inliers[p_wj]
        # Every loop of better-supported basins (both, where a pair's tie)
        # and the seed pair's basin each picks.
        loops = torch.einsum("kab,lbc->klac", basins(p_wj, w, bj), basins(p_iw, bi, w))
        better = (n_wj == n_wj.max())[:, None] & (n_iw == n_iw.max())[None, :]
        pair = basins(p_ij, bi, bj)
        picks = torch.argmin(gap(pair[None, None], loops[:, :, None]), dim=-1)
        first = torch.where(better, picks, 2).min()
        R = exp_so3(st.cameras[[bi, bj], :3])
        to_seed = gap(pair, (R[1] @ R[0].T)[None])
        decisive = (
            (first == torch.where(better, picks, -1).max())
            & (torch.minimum(n_iw.max(), n_wj.max()) >= self.config.matching.min_pair_matches)
        )
        decisive, g_picked, g_other = torch.stack(
            [decisive.to(to_seed.dtype), to_seed[first], to_seed[1 - first]]
        ).tolist()
        return (g_picked, g_other) if decisive else None

    def _grow_component(
        self,
        state: ReconstructionState,
        done: set,
        exclude: set,
        anchor: int,
        max_new_views: Optional[int] = None,
        main: bool = False,
        retry_failed: bool = False,
    ) -> ReconstructionState:
        """Grow one component by PnP registration + triangulation (the
        reference's addMoreViews loop, src/Sfm.cpp:893-1009); `done` is
        updated in place. Registration reads the loose prefiltered table,
        triangulation the strict one. A failed view is retried only after
        the map has grown.

        `main` is the main component's growth (the incremental loop and the
        straggler sweep): there a failed PnP is retried by guided bridge
        registration (`_guided_attempt`), counted in the set's
        `n_guided_registered`; the views registered from the first guided
        success on join its `guided_block` (their placement hangs off a
        pose built on 2D evidence); and the state is checkpointed after
        every registered view. `retry_failed` is `register_view_blind`'s; a
        view whose pick fails blind is noted in the set's `failed_blind`
        for the straggler sweep."""
        inp = self._inputs
        run = self._progress
        V = state.n_views
        ba_cfg = self.config.ba
        n_grown = 0
        fix = self._fix_mask(anchor)
        # The map size the guided attempt's skip reads, kept as the
        # reference keeps it: the point count after the last registration
        # (after a guided one, the count before its triangulation).
        size_pts = int(state.n_points)
        failed: dict = {}
        post_guided = main and bool(run.guided_block)
        progress = True
        while progress:
            progress = False
            stale = {v for v, n in failed.items() if n >= len(done)}
            while True:
                if max_new_views is not None and n_grown >= max_new_views:
                    return state
                frontier = self._frontier(done, stale | exclude, V)
                if not frontier:
                    break
                new_view = frontier[0]
                # Local-window BA once the map is big enough, with a periodic
                # global solve (src/Sfm.cpp:883-888).
                use_local = (
                    len(done) + 1 >= ba_cfg.local_ba_min_views
                    and (n_grown + 1) % ba_cfg.global_ba_every != 0
                )
                state, (ok, n_inl, n_support, n_pts, _, failed_blind) = register_adjust_step(
                    run.next_key(), state, new_view, sorted(done), inp, fix,
                    new_view if use_local else None, run_ba=inp.run_ba_every_view,
                    retry_failed=retry_failed,
                )
                if failed_blind:
                    run.failed_blind.add(new_view)
                else:
                    run.failed_blind.discard(new_view)
                guided = False
                if not ok and main:
                    gr = self._guided_attempt(state, new_view, done, size_pts)
                    if gr is not None:
                        state_g, gs = gr
                        log.info(
                            "view %d guided diag: anch=(%d,%d) basin=%d s=%.3f votes=%d",
                            new_view, *gs["n_anchored"], gs["basin"], gs["scale"], gs["votes"],
                        )
                        if gs["ok"]:
                            state = state_g
                            ok, n_inl, n_support = True, gs["n_inliers"], gs["n_support"]
                            guided = True
                            if inp.run_ba_every_view:
                                state, _ = self._run_global_ba(state, anchor, intermediate=True)
                            run.n_guided_registered += 1
                        else:
                            log.info(
                                "view %d: guided bridge also failed (%d inliers of %d "
                                "guided support)", new_view, gs["n_inliers"], gs["n_support"],
                            )
                if not ok:
                    log.warning(
                        "view %d: PnP failed (%d inliers of %d 2D-3D support), skipping",
                        new_view, n_inl, n_support,
                    )
                    failed[new_view] = len(done)
                    stale.add(new_view)
                    continue
                log.info(
                    "view %d registered (%d %sPnP inliers)", new_view, n_inl,
                    "guided " if guided else "",
                )
                done.add(new_view)
                post_guided = post_guided or guided
                if post_guided:
                    run.guided_block.append(new_view)
                n_grown += 1
                progress = True
                size_pts = n_pts
                if main:
                    self._save_ckpt(state, done, anchor)
            if len(done) + len(exclude) >= V:
                break
        return state

    def _guided_attempt(self, state, new_view: int, done: set, size_pts: int):
        """Host side of guided bridge registration (pipeline/guided.py): the
        coarse-pose candidates from the pose-graph edge to the best-matched
        registered view (rotation from two-view scoring up to the epipolar
        basin, the baseline scale swept over a range set by the component's
        own camera spacing). Returns (state, stats), or None when guided
        bridging is off, too few views are registered, no usable edge exists
        or the map is too large for the (K, B) affinity. The attempt takes a
        registration key only past these checks, as the reference's does."""
        inp = self._inputs
        cfg = self.config
        g = cfg.geometry
        if not g.guided_enable or len(done) < g.guided_min_done:
            return None
        scores, pair_of = inp.scores, inp.pair_of
        n_match = scores.n_matches.cpu().numpy()
        best, d_star = -1, None
        for d in sorted(done):
            p = pair_of.get((min(d, new_view), max(d, new_view)))
            if p is not None and int(n_match[p]) > best:
                best, d_star = int(n_match[p]), d
        if d_star is None or best < 16:
            return None
        p = pair_of[(min(d_star, new_view), max(d_star, new_view))]
        R_rel, t_rel = scores.R_rel[p], scores.t_rel[p]  # (2, 3, 3), (2, 3) per basin
        if d_star < new_view:
            # pair (d, new): x_new = R_rel x_d + t_rel, as stored.
            R_dn, t_dn = R_rel, t_rel
        else:
            # pair (new, d): x_d = R_rel x_new + t_rel -> invert.
            R_dn = R_rel.transpose(1, 2)
            t_dn = -torch.einsum("bji,bj->bi", R_rel, t_rel)
        done_sorted = sorted(done)
        cams = state.cameras[done_sorted]
        C_done = (-torch.einsum("vij,vi->vj", exp_so3(cams[:, :3]), cams[:, 3:])).cpu().numpy()
        # The sweep range from the component's own spacing: the median
        # nearest-neighbour camera-centre distance, both signs, floored at
        # 0.4x (the projection vote has a degenerate attractor at tiny
        # baselines, where every far point projects consistently).
        if len(done_sorted) >= 2:
            d2 = np.linalg.norm(C_done[:, None, :] - C_done[None, :, :], axis=-1)
            np.fill_diagonal(d2, np.inf)
            b_med = float(np.median(d2.min(axis=1)))
        else:
            b_med = 1.0
        n_sweep = (g.guided_n_scales // 2) * 2
        s_pos = np.linspace(0.4, 5.0, n_sweep // 2) * max(b_med, 1e-6)
        sweep = torch.as_tensor(np.concatenate([s_pos, -s_pos]).astype(np.float32), device=self.device)
        if int(1.2 * size_pts) + 64 > 4096 and state.capacity > 8192:
            # The (K, B) affinity would leave the cheap regime; maps this
            # large have dense covisibility and rarely starve anyway. The
            # rule is the reference's bucketed one (a bucket past 8192
            # slots) on its own map-size bookkeeping (`size_pts`), so that
            # both skip alike and take their keys alike.
            log.info("guided bridge skipped: map too large (%d points)", size_pts)
            return None
        log.info(
            "view %d: guided bridge attempt via edge to view %d (%d scored matches, b_med %.4f)",
            new_view, d_star, best, b_med,
        )
        t, kp = inp.tables, inp.kp
        return guided_bridge_register(
            self._progress.next_key(), state, new_view, done_sorted, d_star, R_dn, t_dn, sweep,
            kp.xy, kp.descriptors, kp.valid, inp.colors, t.feat_a, t.feat_b, t.strict, inp.K,
            inp.dist, inp.max_dim, inp.image_size, b_med, cfg,
        )

    def _frontier(self, done: set, failed: set, V: int) -> List[int]:
        """Index-neighbour frontier (+-1 of done views, src/Sfm.cpp:900-931),
        widened to every remaining view once it is exhausted."""
        out = []
        for v in sorted(done):
            for cand in (v - 1, v + 1):
                if 0 <= cand < V and cand not in done and cand not in failed and cand not in out:
                    out.append(cand)
        if not out:
            out = [v for v in range(V) if v not in done and v not in failed]
        return out

    def _run_global_ba(self, state, anchor: int, intermediate: bool = False):
        """Global BA with the final (config.ba.max_iterations) or the
        intermediate budget; returns (state, metrics). With more than one
        shard device, a final solve of at least ba.sharded_min_obs
        observations runs observation-sharded over them."""
        ba_cfg = self.config.ba
        shards = None
        if len(self.shard_devices) > 1 and not intermediate:
            n_obs_live = int(torch.sum(live_observations(state)))
            if n_obs_live >= ba_cfg.sharded_min_obs:
                shards = self.shard_devices
        state, c0, c1, n_it, n_obs = ba_step(
            state, self._inputs.kp.xy, self._inputs.pp, self._fix_mask(anchor), self.config,
            ba_cfg.intermediate_iterations if intermediate else ba_cfg.max_iterations,
            shard_devices=shards,
        )
        n_obs = float(n_obs)
        metrics = {
            "ba_initial_cost": float(c0),
            "ba_final_cost": float(c1),
            "ba_iterations": int(n_it),
            "ba_rms_px": float(np.sqrt(2.0 * float(c1) / max(n_obs, 1.0))),
            "ba_n_obs": n_obs,
            "focal": float(state.focal),
        }
        log.info(
            "BA: cost %.1f -> %.1f (%d iters, RMS %.3f px, %d obs)",
            metrics["ba_initial_cost"], metrics["ba_final_cost"],
            metrics["ba_iterations"], metrics["ba_rms_px"], int(n_obs),
        )
        return state, metrics

    def _accept_reinit(self, cand, snap, anchor: int, tag: str):
        """Polish a re-initialized state (intermediate then final BA) and
        keep it only if it does not regress a polish-only run of `snap`: RMS
        within 0.25 px and at least 80% of its observations. Returns
        (state, ba_metrics, applied)."""
        cand, _ = self._run_global_ba(cand, anchor, intermediate=True)
        cand, m_c = self._run_global_ba(cand, anchor)
        plain, m_p = self._run_global_ba(snap, anchor)
        ok = (
            m_c["ba_rms_px"] <= m_p["ba_rms_px"] + 0.25
            and m_c["ba_n_obs"] >= 0.8 * m_p["ba_n_obs"]
        )
        verdict = "accepted" if ok else "reverted"
        (log.info if ok else log.warning)(
            "%s %s: RMS %.3f px / %d obs (polish-only %.3f px / %d obs)",
            tag, verdict, m_c["ba_rms_px"], int(m_c["ba_n_obs"]),
            m_p["ba_rms_px"], int(m_p["ba_n_obs"]),
        )
        return (cand, m_c, 1.0) if ok else (plain, m_p, 0.0)

    def _rotavg_initialize(self, state: ReconstructionState, done: set) -> ReconstructionState:
        """Global pose re-initialization from the two-view pose graph (loop
        closure): per-edge basin choice against the current poses, chordal
        rotation averaging with two outlier-rejection rounds, a consistency
        gate, a Procrustes rotational gauge, translation averaging with a
        scalar scale + offset gauge fit, multi-view re-triangulation of every
        track, and a re-fuse sweep of every registered view against all
        others. Returns `state` itself when the graph is too thin,
        inconsistent or degenerate. The caller polishes the result."""
        inp = self._inputs
        cfg = self.config
        scores = inp.scores
        dev = state.device
        V = state.n_views
        done_sorted = sorted(done)
        n_reg = len(done_sorted)
        done_idx = torch.tensor(done_sorted, dtype=torch.long, device=dev)
        reg = torch.zeros((V,), dtype=torch.bool, device=dev)
        reg[done_idx] = True
        # Compact the problem to the registered views: an unregistered view
        # would be a zero-degree node whose nullspace hijacks the bottom
        # eigenvectors. Edges touching one get w = 0 and collapse to
        # zero-weight self-loops at compact node 0.
        remap = torch.zeros((V,), dtype=torch.long, device=dev)
        remap[done_idx] = torch.arange(n_reg, device=dev)
        pi = torch.as_tensor([i for i, _ in inp.pair_of], dtype=torch.long, device=dev)
        pj = torch.as_tensor([j for _, j in inp.pair_of], dtype=torch.long, device=dev)
        ci, cj = remap[pi], remap[pj]
        # Per-edge basin: the candidate nearer the current relative rotation.
        R_cur0 = exp_so3(state.cameras[:, :3])
        R_cur_rel = torch.einsum("pab,pcb->pac", R_cur0[pj], R_cur0[pi])  # R_j R_i^T
        dRb = torch.einsum("pkab,pcb->pkac", scores.R_rel, R_cur_rel)
        trb = torch.clamp((dRb.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0, -1.0, 1.0)
        basin = torch.argmax(trb, dim=-1)
        rows = torch.arange(pi.numel(), device=dev)
        R_rel = scores.R_rel[rows, basin]
        t_rel = scores.t_rel[rows, basin]
        w = (
            scores.n_inliers[rows, basin].to(torch.float32)
            * scores.usable * reg[pi] * reg[pj]
        )
        if int(torch.sum(w > 0)) < len(done):
            log.info("rotavg: pose graph too thin — skipping")
            return state
        R_avg, res = average_rotations(ci, cj, R_rel, w, n_reg)
        # Two IRLS rounds with a tightening residual gate.
        w2 = w
        for thr in (cfg.ba.rotavg_outlier_residual, 0.5 * cfg.ba.rotavg_outlier_residual):
            w_new = w2 * (res <= thr)
            if int(torch.sum(w_new > 0)) < len(done):
                break
            w2 = w_new
            R_avg, res = average_rotations(ci, cj, R_rel, w2, n_reg)
        # Consistency gate: a surviving graph that cannot explain itself is
        # not trusted over the incremental estimate.
        n_live = torch.clamp(torch.sum(w2 > 0), min=1)
        mean_res = float(torch.sum(torch.where(w2 > 0, res, torch.zeros_like(res))) / n_live)
        if mean_res > cfg.ba.rotavg_outlier_residual:
            log.warning(
                "rotavg: mean chordal residual %.3f above %.3f after IRLS — "
                "pose graph inconsistent, skipping reinit",
                mean_res, cfg.ba.rotavg_outlier_residual,
            )
            return state
        # Rotational gauge: Procrustes onto the current estimate.
        R_cur = exp_so3(state.cameras[done_idx, :3])
        G = project_so3(torch.sum(torch.einsum("vij,vik->vjk", R_avg, R_cur), dim=0))
        R_new = R_avg @ G
        # Translation averaging under the new rotations; scalar gauge fit.
        C_avg, _ = average_translations(ci, cj, R_new, t_rel, w2, n_reg)
        C_cur = -torch.einsum("vij,vi->vj", R_cur, state.cameras[done_idx, 3:])
        da = C_avg - torch.mean(C_avg, dim=0)
        mean_c = torch.mean(C_cur, dim=0)
        dc = C_cur - mean_c
        denom = float(torch.sum(da * da))
        if denom < 1e-10:
            log.warning(
                "rotavg: averaged centers degenerate (||da||^2 = %.2e) — "
                "skipping reinit", denom,
            )
            return state
        C_new = torch.sum(da * dc) / denom * da + mean_c
        t_new = -torch.einsum("vij,vj->vi", R_new, C_new)
        cameras = state.cameras.clone()
        cameras[done_idx] = torch.cat([log_so3(R_new), t_new], dim=-1)
        dR = torch.einsum("vij,vik->vjk", R_new, R_cur)
        tr = torch.clamp((dR.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2, -1, 1)
        log.info(
            "global reinit over %d views / %d edges: max rotation correction "
            "%.2f deg, max center shift %.3f", len(done), int(torch.sum(w2 > 0)),
            float(torch.rad2deg(torch.arccos(tr)).max()),
            float(torch.linalg.norm(C_new - C_cur, dim=-1).max()),
        )
        state = dataclasses.replace(state, cameras=cameras)
        # Structure refresh + re-fuse sweep (recreates the loop-closing
        # tracks that drift had rejected or pruned).
        state = retriangulate_points(state, inp.kp.xy, _k_matrix(state.focal, inp.pp))
        t = inp.tables
        for v in done_sorted:
            state = triangulate_new_view_all(
                state, v, done_sorted, t.feat_a, t.feat_b, t.strict, inp.kp.xy, inp.colors,
                inp.K, inp.dist, cfg,
            )
        return state
