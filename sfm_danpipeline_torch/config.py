"""Pipeline configuration.

A copy of sfm_danpipeline_tpu/config.py, kept so the port never imports
the JAX package; tests/test_torch_drift.py holds every default equal to
the original's, field by field.

Every tunable constant of the reference pipeline (codebydant/sfM_danPipeline)
becomes a named field with the reference's default value, per SURVEY.md §5
("Config / flag system"). Reference provenance is cited per field.

The reference has no live config system: its CLI parser is commented out
(main.cpp:20-44) and all constants are compile-time literals. Here the whole
pipeline is driven by one frozen dataclass so that jitted functions can close
over static values.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Feature detection (reference: src/Sfm.cpp:303-392, OpenCV SIFT defaults)."""

    # Detector selection ("sift" | "akaze" | "orb") — the reference selects
    # SIFT / AKAZE / ORB by an int (include/Sfm.h:40-61); SIFT is its default.
    detector: str = "sift"
    # AKAZE nonlinear scale space (reference src/Sfm.cpp:333-341: threshold
    # 0.001, nOctaves=4, nOctaveLayers=4, DIFF_PM_G2, full MLDB).
    akaze_threshold: float = 0.001
    akaze_n_octaves: int = 4
    akaze_n_sublevels: int = 4
    # Maximum keypoints kept per image (fixed shape for jit; OpenCV default 0 = unlimited,
    # practical counts on 640x480 are ~1-3k).
    max_keypoints: int = 2048
    # Scale-space layout (OpenCV SIFT defaults; reference selects SIFT with
    # nOctaveLayers=3 at src/Sfm.cpp:315).
    n_octaves: int = 4
    n_scales_per_octave: int = 3
    sigma0: float = 1.6
    # Assumed blur of the input image (OpenCV SIFT convention).
    init_blur: float = 0.5
    # Double the image before the first octave (OpenCV SIFT upsamples by 2x).
    upsample: bool = True
    # DoG contrast threshold (reference src/Sfm.cpp:317: contrastThreshold=0.04).
    contrast_threshold: float = 0.04
    # Edge response ratio threshold (reference src/Sfm.cpp:318: edgeThreshold=10).
    edge_threshold: float = 10.0
    # Descriptor geometry: 4x4 spatial bins x 8 orientations = 128-d (SIFT standard).
    descriptor_width: int = 4
    descriptor_bins: int = 8
    # Orientation histogram bins.
    orientation_bins: int = 36


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Pairwise matching (reference: src/Sfm.cpp:590-608; alternative
    optical-flow path at src/Sfm.cpp:1399-1474)."""

    # Matching method: "bf" (descriptor kNN + ratio) or "flow"
    # (pyramidal LK track + radius association, the reference's
    # MatchFeatures alternative).
    method: str = "bf"
    # LK association radius in px (reference radiusMatch).
    flow_radius: float = 3.0
    # Lowe ratio test threshold (reference include/Sfm.h:60: NN_MATCH_RATIO=0.8).
    ratio: float = 0.8
    # Looser ratio used only for incremental registration + triangulation:
    # weak "bridge" pairs across a viewpoint break yield too few 0.8-matches
    # for PnP (the reference simply loses those views); the extra outliers
    # are absorbed by the epipolar prefilter + PnP RANSAC. One matching pass
    # stores each match's actual ratio (PairMatches.lowe), so baseline
    # scoring still sees exactly the reference's 0.8 set.
    registration_ratio: float = 0.9
    # Minimum ratio-test matches for a usable pair (reference src/Sfm.cpp:533).
    min_pair_matches: int = 120
    # Maximum matches kept per pair (fixed shape for jit).
    max_matches: int = 1024
    # Physical-point radius (px) for multi-orientation keypoint handling:
    # the detector emits 2 rows per position (OpenCV secondary-orientation
    # semantics, src/Sfm.cpp:315-320), so the Lowe second-best skips
    # co-located twins of the best, and duplicate correspondences between
    # the same two physical points collapse to the best-ranked one.
    # 0 disables (plain BFMatcher semantics).
    dup_radius: float = 0.5
    # Also collapse duplicate output correspondences (both endpoints within
    # dup_radius) to the best-ranked one. Off in the pipeline default:
    # duplicate rows of a strong physical point reinforce RANSAC/PnP
    # support on weak bridge pairs, and measured on temple the collapse
    # starves view 9's registration (10/172 PnP inliers).
    dedup_matches: bool = False


@dataclasses.dataclass(frozen=True)
class GeometryConfig:
    """Two-view geometry + RANSAC budgets."""

    # Essential matrix RANSAC (reference src/Sfm.cpp:542,743: p=0.999, thr=1.0 px).
    essential_ransac_iters: int = 512
    essential_threshold_px: float = 1.0
    # Cheaper budget for the per-done-view epipolar PREFILTER inside
    # registration (pipeline/incremental.py): it only prunes gross
    # outliers before PnP, and its 8-point fits are the incremental
    # loop's dominant small-eigh load (D views x iters 9x9 eigh per
    # registration).
    prefilter_ransac_iters: int = 96
    # Min aligned points to attempt pose (reference src/Sfm.cpp:734: >=8).
    min_pose_points: int = 8
    # Homography RANSAC inlier threshold factor (reference src/Sfm.cpp:667-689:
    # 0.004 * max image dimension).
    homography_threshold_factor: float = 0.004
    homography_ransac_iters: int = 256
    # Planar / rotation-only degeneracy gate on SEED pairs: unusable when
    # homography inliers exceed this fraction of essential inliers (the
    # live form of the reference's findHomographyInliers pair scoring,
    # src/Sfm.cpp:545,667-689; COLMAP's init uses the same H/E criterion).
    max_seed_h_over_e: float = 0.92
    # Triangulation acceptance: reprojection error in both views
    # (reference src/Sfm.cpp:850: <= 6.0 px).
    max_reprojection_error_px: float = 6.0
    # PnP RANSAC (reference src/Sfm.cpp:1153-1154: EPNP, 1000 iters, conf 0.99,
    # thr 0.006 * max dimension). We use 4096 vmapped hypotheses: the 6-point
    # DLT minimal sample needs more draws than EPnP's smaller sample to hit
    # an all-inlier set at high outlier rates, and on TPU the extra
    # hypotheses are nearly free (one batched pass). 2048 (r4, was
    # 4096): healthy registrations run >=60% inliers where 2048 3-point
    # draws are overkill by orders of magnitude; marginal bridge views
    # fail at ANY budget (see pnp_min_inliers) and route to the
    # component+merge path, so the extra draws bought nothing.
    pnp_ransac_iters: int = 2048
    pnp_threshold_factor: float = 0.006
    # Reject PnP poses translated implausibly far (reference src/Sfm.cpp:1175: ||T||<=200).
    pnp_max_translation: float = 200.0
    # Minimum PnP inlier support to accept a registration. The reference
    # accepts whatever solvePnPRansac returns; a near-minimal consensus
    # is almost always a mirage that corrupts the map. 30 (r4, was 12):
    # healthy registrations run 250-430 inliers on temple while marginal
    # cross-break bridges max out near ~12 — and a 12-inlier direct
    # registration measured WORSE than leaving the view to the verified
    # secondary-component + Sim(3) path (it steals a view from the
    # component seed and the remainder can't merge; seed-sweep seeds 2-3,
    # and a 23-27-inlier chain bent the map measurably on seed 2).
    pnp_min_inliers: int = 30
    # Point-merge radius during incremental growth (reference src/Sfm.cpp:1216: 0.01).
    merge_distance: float = 0.01
    # --- Guided bridge registration (pipeline/guided.py). When a view
    # fails transitive PnP (the reference loses such views outright,
    # src/Sfm.cpp:955-958), re-attempt with map-projection guided
    # matching: rotation from the pose-graph edge to the best-matched
    # done view, baseline scale from a 1-parameter consensus sweep,
    # support from direct keypoint-vs-projected-map descriptor matching.
    # The PnP acceptance bar (pnp_min_inliers) is unchanged.
    # DEFAULT OFF (r5 measurement): on the temple's near-periodic
    # colonnade the guided chain registers 10/10 in one component but its
    # cross-break pose quality is seed-unstable (5-seed ATE 3.2-12.1% of
    # trajectory diameter vs 0.34% via the secondary-component + Sim(3)
    # merge path; two seeds breach the 5% gate), and the structural
    # block-realign pass cannot reliably recover it (2-15 Sim(3) inliers
    # of ~200 candidates — the bent basin suppresses the true-mode
    # evidence). The verified merge path stays the default; enable for
    # scenes without repeated structure or for experimentation.
    guided_enable: bool = False
    # Minimum registered views before the guided fallback may fire (a
    # tiny map projects too little support to be trustworthy).
    guided_min_done: int = 4
    # Projection-locality radius (px) for the first guided match — wide
    # enough to absorb the epipolar rotation error of a thin bridge edge.
    guided_radius_px: float = 24.0
    # Tight re-match radius (px) at the PnP-refined pose.
    guided_radius2_px: float = 8.0
    # L2 descriptor distance bound for a guided correspondence
    # (unit-norm SIFT; the ratio test is replaced by the spatial prior).
    guided_desc_threshold: float = 0.9
    # Stricter descriptor bound for the scale-sweep votes (votes must be
    # discriminative; matching retries at the looser bound above).
    guided_sweep_desc_threshold: float = 0.8
    # Vote radius (px) during the scale sweep.
    guided_sweep_radius_px: float = 12.0
    # Scale-sweep resolution (candidate baseline scales per basin,
    # covering both baseline signs).
    guided_n_scales: int = 96
    # Keep the guided correspondences as permanent track observations
    # (False = use them for the pose only; the view's lasting constraints
    # then come from ordinary pairwise triangulation).
    guided_keep_obs: bool = True
    # Minimum median triangulation angle (deg) for a two-view SEED
    # reconstruction. Rejects degenerate low-parallax interpretations
    # (narrow-FOV rotation/translation ambiguity: the spurious basin
    # triangulates a cone of rays at ~0.1 deg parallax). The reference has
    # no guard (cv::recoverPose's answer is trusted, src/Sfm.cpp:755);
    # COLMAP's analogue defaults to 16 deg — we use a permissive 1.5 deg
    # because third-view validation (pipeline/sfm.py) is the decisive test.
    min_seed_triangulation_angle_deg: float = 1.5
    # Post-merge acceptance: median reprojection error (px) of the merged
    # component's observations through the transformed cameras. A Sim(3)
    # with enough 3D-3D inliers can still be wrong-scale; reprojection
    # through the merged cameras is the decisive check.
    max_merge_reprojection_px: float = 8.0
    # RANSAC determinism: base PRNG seed (reference relies on OpenCV's RNG; we fix keys
    # for bitwise reproducibility per SURVEY.md §5 "race detection" note).
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Bundle adjustment (reference: src/BundleAdjustment.cpp:115-121).

    Reference solver: Ceres AutoDiff + DENSE_SCHUR, <=500 iterations, eta 1e-2,
    <=10 s wall clock, camera = 6-dof angle-axis + t with one shared focal.
    Ours is a from-scratch Levenberg-Marquardt with Schur elimination of points.
    """

    max_iterations: int = 50
    # LM budget for the per-view (intermediate) adjustments during the
    # incremental loop; the final global BA uses max_iterations. The
    # reference intended per-view local BA + global polish
    # (adjustCurrentBundle, src/Sfm.cpp:883-888,996). 8 iterations (r4,
    # was 12) measured indistinguishable final quality on temple (RMS
    # 0.726 vs 0.751, seed sweep green) at ~-30% per-view BA wall.
    intermediate_iterations: int = 8
    # LM damping schedule.
    init_lambda: float = 1e-3
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    max_lambda: float = 1e8
    min_lambda: float = 1e-10
    # Relative cost-decrease convergence tolerance (Ceres eta=1e-2 analogue).
    rtol: float = 1e-8
    # Local-window BA (the reference's intended per-view adjustCurrentBundle
    # cadence, src/Sfm.cpp:883-888,996): once the map holds at least
    # local_ba_min_views cameras, each registration adjusts only the new
    # view + its (local_window - 1) most covisible cameras + the points the
    # new view observes, with a full global solve every global_ba_every
    # registrations and at the end. Keeps per-view BA cost ~constant in map
    # size (VERDICT r2 weak #5: O(V) full solves do not scale).
    local_window: int = 8
    local_ba_min_views: int = 12
    global_ba_every: int = 4
    # Observation-sharded BA pays one collective (psum of the reduced
    # normal blocks) per LM iteration. On ICI that is ~free; over
    # gloo/DCN it costs more than the whole temple-size solve (measured
    # r4: final BA 0.37 s replicated vs 5.74 s sharded at 2 CPU
    # processes). Route the global solves through the sharded path only
    # when the problem is big enough for compute to dominate comm.
    sharded_min_obs: int = 50000
    # Rotation-averaging initialization before the FINAL global BA once at
    # least this many views are registered (0 disables). On long/closed
    # camera rings the incremental chain accumulates rotation drift that
    # local LM cannot redistribute (it converges to the drifted basin);
    # chordal averaging over the two-view pose-graph edges (ops/rotavg.py)
    # re-initializes all rotations jointly, closing the loop. Small scenes
    # (like the 10-view temple) are below the threshold and unaffected.
    rotavg_min_views: int = 16
    # Drop pose-graph edges whose chordal residual exceeds this after the
    # first averaging round (wrong-basin / outlier relative rotations),
    # then re-average — one IRLS-style reweighting pass.
    rotavg_outlier_residual: float = 0.5
    # Optimize the shared focal length. The reference's Ceres code does
    # (BundleAdjustment.cpp:79,133) but its call sites are stubbed out
    # (src/Sfm.cpp:492,886) so it never actually runs; with a calibrated K
    # (the pipeline requires a calibration XML) optimizing focal on few-view
    # problems lets it drift wildly (observed 1520 -> 2069 on the temple
    # bootstrap). Default off; enable for uncalibrated use.
    optimize_focal: bool = False


@dataclasses.dataclass(frozen=True)
class MVSConfig:
    """Dense reconstruction replacing the PMVS2 binary (reference src/Sfm.cpp:1246-1303).

    Reference PMVS2 options (src/Sfm.cpp:1258-1264): level 1, csize 2, threshold 0.7,
    wsize 7, minImageNum 5 (with 10 images), CPU 4. Ours is a TPU plane-sweep /
    patch-match depth pipeline with NCC cost and multi-view fusion.
    """

    n_depth_planes: int = 128
    window_size: int = 7
    ncc_threshold: float = 0.7
    # Depth kernel: "rectified" = stereo-rectified sweep (constant
    # disparity per plane — slices instead of per-depth gathers, the
    # TPU-fast path, mvs/rectsweep.py); "sweep" = direct plane sweep
    # (homography warp per depth, mvs/planesweep.py — the r3 kernel,
    # kept as the reference implementation the rectified path is
    # validated against in tests/test_mvs.py).
    method: str = "rectified"
    # Half-resolution depth maps (PMVS2 level 1 == one pyramid level down).
    level: int = 1
    # Minimum consistent views for a fused point (PMVS2 minImageNum=5 with N=10;
    # we scale as max(2, n_images // 2) when unset).
    min_consistent_views: int = 3
    depth_consistency: float = 0.01


@dataclasses.dataclass(frozen=True)
class AnalysisConfig:
    """Cloud filtering, segmentation, dendrometry (reference src/Sfm.cpp:1323-1345,
    src/Segmentation.cpp:24-35, src/DendrometryE.cpp)."""

    # PassThrough filter on x in [0.003, 0.83] (reference src/Sfm.cpp:1327-1331).
    passthrough_axis: str = "x"
    passthrough_min: float = 0.003
    passthrough_max: float = 0.83
    # RadiusOutlierRemoval: radius 0.07, >=150 neighbors (reference src/Sfm.cpp:1337-1343).
    outlier_radius: float = 0.07
    outlier_min_neighbors: int = 150
    # Segmentation PassThrough on z in [0, 14] (reference src/Segmentation.cpp:24-28).
    seg_z_min: float = 0.0
    seg_z_max: float = 14.0
    # RegionGrowingRGB thresholds (reference src/Segmentation.cpp:29-35):
    # distance 10, point color 6, region color 5, min cluster size 600.
    seg_distance: float = 10.0
    seg_point_color: float = 6.0
    seg_region_color: float = 5.0
    seg_min_cluster: int = 600
    # Poisson meshing params (reference src/Sfm.cpp:1360-1381): depth 7, pointWeight 4,
    # samplesPerNode 1.5, scale 1.1, isoDivide 8, solverDivide 8, normals k=10.
    mesh_poisson_depth: int = 7
    mesh_normal_k: int = 10


@dataclasses.dataclass(frozen=True)
class ImageConfig:
    """Image loading (reference src/Sfm.cpp:118-198)."""

    # Downscale factor applied when an image exceeds 640x480
    # (reference src/Sfm.cpp:150-160: resize by 0.6).
    resize_factor: float = 0.6
    max_width: int = 640
    max_height: int = 480


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout for sharded matching and BA (new capability; see SURVEY.md §5
    'Distributed communication backend')."""

    # Name of the data-parallel mesh axis over which observations / image pairs shard.
    axis: str = "d"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    features: FeatureConfig = dataclasses.field(default_factory=FeatureConfig)
    matching: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    geometry: GeometryConfig = dataclasses.field(default_factory=GeometryConfig)
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)
    mvs: MVSConfig = dataclasses.field(default_factory=MVSConfig)
    analysis: AnalysisConfig = dataclasses.field(default_factory=AnalysisConfig)
    images: ImageConfig = dataclasses.field(default_factory=ImageConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    # Maximum 3D points tracked by the incremental engine (fixed capacity for jit).
    max_points: int = 65536

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = PipelineConfig()
