#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (sfm_danpipeline_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and nvidia-smi; imports nothing of JAX. Phases,
each printed on its own line; any failure raises and exits non-zero:

  1. the card's name and power limit (nvidia-smi);
  2. build every hand-written kernel of the main path from csrc/, with what
     ptxas reports (registers, shared memory, spills);
  3. each kernel against its plain PyTorch version on the card: at the
     main-path shape and at the V=20 shape with both versions' median
     times, the bound and the share of it, then on inputs built to break
     the kernel (co-located groups, 0/1 descriptors at D = 256 and 512, a
     ragged keypoint count, a width that is no multiple of 4);
  4. the port's SfMPipeline.run on the V=10 rendered courtyard at
     480x640 with the default PipelineConfig, held against ground truth,
     with the kernel launch counts of that run;
  5. SfMPipeline.run on the V=20 arc (480x640, default config), which
     splits into two components: the merge, the straggler sweep, the
     rotation-averaging reinit and local-window BA all run; held to the
     merge and quality gates and printed beside the reference's numbers;
  6. the dense stage (mvs.pipeline.densify) on the phase-5 result, held
     to the dense gates and to the reference's point count;
  7. repeatability on the card, bit for bit: each detector twice on one
     image pair, the RANSAC pose twice from one seed, a BA step twice from
     one state;
  8. the command line's stage runner (cli.run_stages: sfm, dense,
     filter, mesh, segment, dendrometry, with a checkpoint) with the AKAZE
     detector on the V=10 courtyard at 480x640, held to the quality gates
     and printed beside the reference's numbers; every artifact is read
     back; knn2 is held against knn2_torch on that run's own D = 512
     descriptors, and timed;
  9. resume: (a) the stage runner again from phase 8's checkpoint without
     the sfm stage; (b) SfMPipeline on a copy of the checkpoint taken when
     the 6th view of phase 8's run was registered, which must end as that
     run did;
 10. SfMPipeline with the ORB detector (knn2 at D = 256 on real
     descriptors, held and timed) and with the LK-flow matcher over three
     RANSAC seeds, which launches no kernel;

then the kernel summary line (launches summed over every pipeline run), and
as the last line the device record {"ok": true, "device": {...}}.

One-off measurements (stage timings of two commits, the determinism audit,
the flow path over RANSAC seeds) are in tools/torch_stage_probe.py.
"""
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Main-path shape of the matching stage: V = 10 views -> 45 pairs,
# max_keypoints = 2048 SIFT descriptors of 128 floats per view.
N_VIEWS, K, D = 10, 2048, 128
DUP_R2 = 0.25  # MatchConfig.dup_radius = 0.5 px
KNN2_RTOL, KNN2_ATOL = 1e-5, 1e-6
KNN2_TIE = 1e-5  # an index may differ only where d2 ties to 1e-5*max(1, d2)
# The JAX reference on the V=20 arc (default config, CPU run): 20/20 in
# two components merged once, 3,240 points, RMS 0.192 px, ATE 0.0735% of
# the diameter; its dense stage gives 11,594 points.
REF_V20 = {"n_points": 3240, "ba_rms_px": 0.192, "ate_pct": 0.0735}
REF_V20_DENSE_POINTS = 11594
# The JAX reference's command-line program on the V=10 courtyard with
# --detector akaze and every stage (CPU run), and its SfMPipeline with ORB
# (ratio 0.9) on the same scene and with the flow matcher on the
# ring_fraction=0.05 arc. ORB and flow miss the 1% trajectory gate in the
# reference too, so the port's ATE is printed beside them, not gated.
REF_AKAZE = {
    "n_points": 4159, "ba_rms_px": 0.602, "ate_pct": 0.217, "kp": 1903.1,
    "dense_points": 18843, "filter_after": 4288, "mesh_faces": 71754,
    "n_clusters": 2, "total_height": 9.467,
}
REF_ORB = {"n_points": 5163, "ba_rms_px": 0.586, "ate_pct": 6.74, "kp": 2008.0}
REF_FLOW = {"n_points": 1732, "ba_rms_px": 0.841, "ate_pct": 1.23, "kp": 933.2}
# The flow path over RANSAC seeds 0-5 in the reference (CPU runs): the narrow
# arc is marginal for it (only adjacent views share more than ~150 flow
# matches, 1.8 degrees apart), so three seeds find no seed pair and the other
# three end at these trajectory errors (% of the diameter). The two packages
# draw other random numbers from one seed, so the port is held to this
# distribution over its own seeds, not to one run: each of FLOW_SEEDS must
# register every view, and their median ATE must not pass the reference's
# worst.
REF_FLOW_SEED_ATE_PCT = {0: 1.231, 1: 2.007, 4: 12.905}
REF_FLOW_SEEDS_FAILED = (2, 3, 5)
FLOW_SEEDS = (0, 1, 2)
RESUME_AT_VIEWS = 6


def _require(cond, msg):
    """A check that holds under python -O too."""
    if not cond:
        raise AssertionError(msg)


def _median_ms(fn, n=10):
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# Published peaks of one H100 SXM at its full power limit: float32
# multiply-add outside the tensor cores, and device-memory bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def knn2_bound(n_views, n_pairs, k, d):
    """The least time (ms) the card could take for one knn2 call, and what
    sets it: every input read once and every output written once over the
    memory rate, or one fp32 multiply-add per (a, b, element) over the fp32
    rate outside the tensor cores (the kernel's arithmetic is plain fp32)."""
    flops = 2.0 * n_pairs * k * k * d
    nbytes = n_views * k * (4 * d + 1 + 8) + 2 * 4 * n_pairs + n_pairs * k * 12
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def check_knn2_case(name, case, exact_idx=False, timed=False):
    """One input set through the kernel and through knn2_torch on the card,
    held to KNN2_RTOL / KNN2_ATOL / KNN2_TIE (or to equal indices). Prints
    one line; returns the numbers of the kernels line when `timed`."""
    from sfm_danpipeline_torch.ops.matching import _launch_knn2, knn2, knn2_torch
    from sfm_danpipeline_torch.utils.knn_cases import compare_knn2, to_tensors

    desc, valid, xy, pi, pj = to_tensors(case, "cuda")
    pil, pjl = pi.long(), pj.long()
    n, k, d = desc.shape

    def plain():
        return knn2_torch(desc[pil], desc[pjl], valid[pjl], xy[pjl], case.dup_r2)

    def kernel():
        return knn2(desc, valid, xy, pi, pj, case.dup_r2)

    got = kernel()
    torch.cuda.synchronize()  # a fault during the run surfaces here
    flagged = int(knn2.last_flagged)
    n_mism, max_err = compare_knn2(
        got, plain(), desc, valid, pi, pj,
        rtol=KNN2_RTOL, atol=KNN2_ATOL, tie=KNN2_TIE, exact_idx=exact_idx,
    )
    line = (
        f"knn2 {name}: P={pi.numel()} Ka=Kb={k} D={d} dup_r2={case.dup_r2}: "
        f"{n_mism} index mismatches ({'none allowed' if exact_idx else 'all near-ties'}), "
        f"max |d2 err| {max_err:.3e} (rtol {KNN2_RTOL}, atol {KNN2_ATOL}); "
        f"second sweep took {flagged} of {pi.numel() * k} rows"
    )
    row = {"max_abs_err": max_err, "flagged_rows": flagged}
    if timed:
        bound = knn2_bound(n, pi.numel(), k, d)
        # `ms` is the wrapper as the main path calls it (its pair-bounds check
        # reads two numbers back from the card); `launch_ms` the launch alone.
        ms = _median_ms(kernel)
        ms_l = _median_ms(lambda: _launch_knn2(desc, valid, xy, pi, pj, case.dup_r2))
        ms_p = _median_ms(plain)
        line += (
            f"; median wrapper {ms:.3f} ms (launch alone {ms_l:.3f} ms), "
            f"knn2_torch {ms_p:.3f} ms, bound "
            f"{bound['bound_ms']:.3f} ms by {bound['bound_by']} ({bound['gflop']:.2f} GFLOP, "
            f"{bound['mbytes']:.1f} MB), share of bound {100 * bound['bound_ms'] / ms:.1f}% "
            f"(launch alone {100 * bound['bound_ms'] / ms_l:.1f}%)"
        )
        row.update(
            ms=ms, launch_ms=ms_l, plain_ms=ms_p, bound_ms=bound["bound_ms"],
            bound_by=bound["bound_by"], library_ms=None,
        )
    print(line)
    return row


def check_knn2():
    """Phase 3: the kernel against knn2_torch at the main-path shape (timed),
    at the V=20 shape (timed), and on the inputs built to break it."""
    from sfm_danpipeline_torch.utils import knn_cases

    row = check_knn2_case("main path (V=10)", knn_cases.matches_case(N_VIEWS, K, D, DUP_R2), timed=True)
    check_knn2_case("V=20 shape", knn_cases.matches_case(20, K, D, DUP_R2), timed=True)
    colo = check_knn2_case("co-located groups of 3-6", knn_cases.colocated_case(K, D))
    _require(colo["flagged_rows"] > 0, "knn2: the exact second sweep did not run")
    for width in (256, 512):
        check_knn2_case(f"0/1 descriptors D={width}", knn_cases.binary_case(K, width), exact_idx=True)
    check_knn2_case("ragged K, no exclusion", knn_cases.ragged_case(1000, D))
    check_knn2_case("width padded to 132", knn_cases.matches_case(3, K, 130, DUP_R2))
    row.pop("flagged_rows")
    return row


def _kernel_wrappers():
    from sfm_danpipeline_torch.ops.matching import knn2

    return {"knn2": knn2}


def _count_launches(fn):
    """Run fn with every kernel's launch count set to 0 just before and
    read just after; returns (result, {kernel: launches})."""
    wrappers = _kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: w.launches for name, w in wrappers.items()}


@functools.lru_cache(maxsize=None)
def courtyard(n_views, ring_fraction):
    from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene

    t0 = time.time()
    scene = make_courtyard_scene(n_views=n_views, ring_fraction=ring_fraction, seed=0)
    print(
        f"scene: rendered {n_views} views 480x640 (ring_fraction {ring_fraction}) "
        f"in {time.time() - t0:.1f}s"
    )
    return scene


def ate_fraction(scene, cameras, regs):
    """Trajectory error of the registered cameras after similarity
    alignment, as a fraction of the ground-truth trajectory's diameter."""
    from sfm_danpipeline_torch.utils.metrics import aligned_rmse, camera_centers

    regs = sorted(regs)
    c = camera_centers(np.asarray(cameras, np.float32))[regs]
    g = scene.centers[regs]
    diam = float(np.linalg.norm(g.max(0) - g.min(0)))
    return aligned_rmse(c, g) / diam if len(regs) >= 3 else float("nan")


def run_pipeline(n_views, ring_fraction, components):
    """Phases 4 and 5: SfMPipeline.run on the card, held against ground
    truth. Returns (scene, result, launches)."""
    from sfm_danpipeline_torch.config import PipelineConfig
    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline

    scene = courtyard(n_views, ring_fraction)
    pipe = SfMPipeline(PipelineConfig(), device="cuda")
    res, launches = _count_launches(lambda: pipe.run(scene.images, scene.intrinsics))
    m = res.metrics
    ate_frac = ate_fraction(scene, res.state.cameras.cpu().numpy(), res.registered_views)
    stages = {k: round(v, 3) for k, v in m.items() if k.startswith("t_")}
    print(f"V={n_views} stages (s): {json.dumps(stages)}")
    print(
        "V=%d quality: registered %d/%d, components %d (merged %d), RMS %.3f px, "
        "ATE %.4f%% of diameter, %d points, %.0f keypoints/image, knn2 launches %d "
        "(second sweep took %d of %d rows)"
        % (
            n_views, m["n_registered"], n_views, m["n_components"],
            m["n_merged_components"], m["ba_rms_px"], 100 * ate_frac, m["n_points"],
            m["n_keypoints_mean"], launches["knn2"], int(_kernel_wrappers()["knn2"].last_flagged),
            n_views * (n_views - 1) // 2 * res.keypoints.valid.shape[1],
        )
    )
    _require(m["n_registered"] == n_views, f"registered {m['n_registered']}/{n_views}")
    if components == 1:
        _require(m["n_components"] == 1, f"{m['n_components']} components")
    else:
        print(
            "V=%d merge: %d components, %d merged, %d cross tracks, post-BA "
            "cross-track median %.3f px; rotavg %s"
            % (
                n_views, m["n_components"], m["n_merged_components"],
                m.get("n_cross_tracks", 0), m.get("merge_cross_med_px", float("inf")),
                "fired, applied %d" % m["rotavg_applied"] if "rotavg_applied" in m
                else "did not fire",
            )
        )
        print(
            "V=%d reference (JAX, CPU): %d points, RMS %.3f px, ATE %.4f%%; port "
            "(card): %d points, RMS %.3f px, ATE %.4f%%"
            % (
                n_views, REF_V20["n_points"], REF_V20["ba_rms_px"], REF_V20["ate_pct"],
                m["n_points"], m["ba_rms_px"], 100 * ate_frac,
            )
        )
        _require(m["n_merged_components"] >= 1, "no component was merged")
        _require("rotavg_applied" in m, "rotation averaging did not fire")
        _require(m.get("n_cross_tracks", 0) >= 20, f"{m.get('n_cross_tracks')} cross tracks < 20")
        _require(
            m.get("merge_cross_med_px", float("inf")) < 4.0,
            f"merge cross-track median {m.get('merge_cross_med_px')} px >= 4",
        )
    _require(m["ba_rms_px"] < 1.0, f"BA RMS {m['ba_rms_px']} px >= 1")
    _require(ate_frac < 0.01, f"ATE {ate_frac} of diameter >= 1%")
    _require(
        res.points.ndim == 2 and res.points.shape[1] == 3
        and len(res.points) > 0 and np.isfinite(res.points).all(),
        "sparse cloud is empty or not finite",
    )
    for name, n in launches.items():
        _require(n >= 1, f"kernel {name} was not launched on the main path")
    return scene, res, launches


def run_dense(scene, res):
    """Phase 6: the dense stage on the card, held to bench.py's dense gates
    and to the reference's point count on the same scene."""
    from sfm_danpipeline_torch.config import MVSConfig
    from sfm_danpipeline_torch.mvs.pipeline import densify

    dense, launches = _count_launches(
        lambda: densify(scene.images, scene.intrinsics, res.state, MVSConfig(), device="cuda")
    )
    m = dense.metrics
    print(
        "dense: %d points (reference %d), coverage %.3f, sparse-depth median "
        "rel err %.4f over %d pixels, t_dense %.3f s"
        % (
            m["n_dense_points"], REF_V20_DENSE_POINTS, m["depth_coverage"],
            m["sparse_depth_med_rel_err"], m["sparse_depth_n_audited"], m["t_dense"],
        )
    )
    _require(m["depth_coverage"] >= 0.30, f"dense coverage {m['depth_coverage']} < 0.30")
    _require(
        m["sparse_depth_med_rel_err"] < 0.02,
        f"dense sparse-depth error {m['sparse_depth_med_rel_err']} >= 0.02",
    )
    _require(
        abs(m["n_dense_points"] - REF_V20_DENSE_POINTS) <= 0.2 * REF_V20_DENSE_POINTS,
        f"{m['n_dense_points']} dense points, not within 20% of {REF_V20_DENSE_POINTS}",
    )
    _require(
        dense.points.ndim == 2 and dense.points.shape[1] == 3
        and np.isfinite(dense.points).all(),
        "dense cloud is not finite",
    )
    return launches


def _bit_equal(name, a, b):
    """Raise unless two results (tensors, numbers, or containers of them)
    are equal bit for bit."""
    if isinstance(a, torch.Tensor):
        _require(torch.equal(a, b), f"repeatability: {name} differs between two runs")
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _bit_equal(f"{name}.{f.name}", getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            _bit_equal(f"{name}[{i}]", x, y)
    else:
        _require(a == b, f"repeatability: {name} differs between two runs ({a} vs {b})")


def check_repeatability(scene, res):
    """Phase 7: the reference asserts bitwise-equal reruns (its detector,
    RANSAC and artifact tests); the port's counterparts on the card."""
    from sfm_danpipeline_torch.config import PipelineConfig
    from sfm_danpipeline_torch.ops.akaze import detect_and_compute_akaze_batch
    from sfm_danpipeline_torch.ops.epipolar import estimate_relative_pose
    from sfm_danpipeline_torch.ops.matching import match_pair
    from sfm_danpipeline_torch.ops.orb import detect_and_compute_orb_batch
    from sfm_danpipeline_torch.ops.projection import undistort_points
    from sfm_danpipeline_torch.ops.sift import detect_and_compute_batch
    from sfm_danpipeline_torch.pipeline.sfm import ba_step

    cfg = PipelineConfig()
    gray = torch.as_tensor(scene.images.gray[:2], device="cuda")
    detectors = {
        "sift": lambda: detect_and_compute_batch(gray, cfg.features),
        "akaze": lambda: detect_and_compute_akaze_batch(gray, cfg.features),
        "orb": lambda: detect_and_compute_orb_batch(gray, cfg.features.max_keypoints),
    }
    for name, fn in detectors.items():
        first = fn()
        _bit_equal(f"detector {name}", first, fn())
        if name == "sift":
            kp = first
    print("repeatability: detectors (sift, akaze, orb) twice on two images: equal bit for bit")

    m = match_pair(
        kp.descriptors[0], kp.valid[0], kp.descriptors[1], kp.valid[1], ratio=cfg.matching.ratio,
        xy_a=kp.xy[0], xy_b=kp.xy[1], dup_radius=cfg.matching.dup_radius,
    )
    K = torch.as_tensor(scene.intrinsics.K, dtype=torch.float32, device="cuda")
    dist = torch.as_tensor(scene.intrinsics.dist, dtype=torch.float32, device="cuda")
    x1 = undistort_points(kp.xy[0][m.idx_a.long()], K, dist)
    x2 = undistort_points(kp.xy[1][m.idx_b.long()], K, dist)

    def pose():
        gen = torch.Generator(device="cuda").manual_seed(0)
        return estimate_relative_pose(gen, x1, x2, m.valid, focal=scene.intrinsics.fx)

    first = pose()
    _bit_equal("RANSAC pose", tuple(first), tuple(pose()))
    _require(bool(first.ok), "repeatability: the RANSAC pose of views 0-1 failed")
    print(
        f"repeatability: RANSAC pose twice from one seed ({int(m.valid.sum())} matches, "
        f"{int(first.n_inliers)} inliers): equal bit for bit"
    )

    # A BA step from the finished V=10 state with its points shaken.
    g = torch.Generator(device="cuda").manual_seed(1)
    st = res.state
    noise = 0.01 * torch.randn(st.points_xyz.shape, generator=g, device="cuda")
    st = dataclasses.replace(st, points_xyz=st.points_xyz + noise)
    pp = torch.tensor([scene.intrinsics.cx, scene.intrinsics.cy], device="cuda")
    fix = torch.zeros(st.n_views, dtype=torch.bool, device="cuda")
    fix[int(res.metrics["baseline_pair_i"])] = True

    def ba():
        out, c0, c1, n_it, n_obs = ba_step(st, res.keypoints.xy, pp, fix, cfg, 6)
        return out, c0, c1, n_it, n_obs

    first = ba()
    _bit_equal("BA step", first, ba())
    _require(float(first[2]) < float(first[1]), "repeatability: the BA step did not descend")
    print(
        f"repeatability: BA twice from one state ({int(first[4])} observations, cost "
        f"{float(first[1]):.1f} -> {float(first[2]):.1f} in {first[3]} iterations): equal bit for bit"
    )


def check_knn2_on_run(name, res, cfg):
    """The kernel against knn2_torch on a finished run's own descriptors,
    every pair, indices held equal; timed in the form of phase 3."""
    from sfm_danpipeline_torch.utils.knn_cases import KnnCase

    kp = res.keypoints
    n = kp.valid.shape[0]
    pi, pj = np.triu_indices(n, 1)
    case = KnnCase(
        kp.descriptors.cpu().numpy(), kp.valid.cpu().numpy(), kp.xy.cpu().numpy(),
        pi.astype(np.int32), pj.astype(np.int32), cfg.matching.dup_radius**2,
    )
    return check_knn2_case(name, case, exact_idx=True, timed=True)


def _print_run(tag, m, ate_frac, ref):
    stages = {k: round(v, 3) for k, v in m.items() if k.startswith("t_")}
    print(f"{tag} stages (s): {json.dumps(stages)}")
    print(
        "%s quality: registered %d, components %d, RMS %.3f px, ATE %.4f%% of diameter, "
        "%d points, %.1f keypoints/image; reference (JAX, CPU): RMS %.3f px, ATE %.3f%%, "
        "%d points, %.1f keypoints/image"
        % (
            tag, m["n_registered"], m["n_components"], m["ba_rms_px"], 100 * ate_frac,
            m["n_points"], m["n_keypoints_mean"], ref["ba_rms_px"], ref["ate_pct"],
            ref["n_points"], ref["kp"],
        )
    )


def _cli_config(detector, matcher="bf"):
    """The config the command line builds for --detector / --matcher."""
    from sfm_danpipeline_torch import cli

    return cli.config_from_args(cli.build_parser().parse_args(
        ["--images", "-", "--calibration", "-", "--detector", detector, "--matcher", matcher]
    ))


def run_cli_akaze(scene, workdir):
    """Phase 8. Returns (run, launches, paths, knn2 row at D = 512)."""
    from sfm_danpipeline_torch import cli
    from sfm_danpipeline_torch.io.native import read_ply_fast
    from sfm_danpipeline_torch.io.ply import read_pcd, read_ply
    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline

    cfg = _cli_config("akaze")
    out = os.path.join(workdir, "out_akaze")
    ckpt = os.path.join(workdir, "akaze_state.npz")
    ckpt_cut = os.path.join(workdir, "akaze_state_cut.npz")
    stages = ["sfm", "dense", "filter", "mesh", "segment", "dendrometry"]

    # Keep a copy of the per-view checkpoint as it was when the 6th view was
    # registered: phase 9 resumes from it.
    save = SfMPipeline._save_ckpt

    def save_and_copy(self, state, done, lost, anchor):
        save(self, state, done, lost, anchor)
        if len(done) == RESUME_AT_VIEWS and not os.path.exists(ckpt_cut):
            shutil.copy(ckpt, ckpt_cut)

    SfMPipeline._save_ckpt = save_and_copy
    try:
        run, launches = _count_launches(lambda: cli.run_stages(
            scene.images, scene.intrinsics, cfg, out, stages, device="cuda", checkpoint=ckpt,
        ))
    finally:
        SfMPipeline._save_ckpt = save
    _require(run.code == 0, f"the stage runner returned {run.code} (the reference returns 0)")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rec = {r["stage"]: r for r in map(json.loads, f)}
    m = rec["sfm"]
    with open(os.path.join(out, "cameras.json")) as f:
        cams = json.load(f)
    ate_frac = ate_fraction(scene, cams["cameras"], cams["registered_views"])
    _print_run("AKAZE V=10 (CLI)", m, ate_frac, REF_AKAZE)
    print(f"AKAZE V=10 (CLI) stage runner times (s): {json.dumps({k: round(v, 3) for k, v in rec['timing'].items() if k.startswith('t_')})}")
    _require(m["n_registered"] == 10 and cams["registered_views"] == list(range(10)), "AKAZE: not 10/10")
    _require(m["n_components"] == 1, f"AKAZE: {m['n_components']} components")
    _require(m["ba_rms_px"] < 1.0, f"AKAZE: BA RMS {m['ba_rms_px']} px >= 1")
    _require(ate_frac < 0.01, f"AKAZE: ATE {ate_frac} of diameter >= 1%")
    _require(launches["knn2"] == 1, f"AKAZE: knn2 launched {launches['knn2']} times, not once")
    _require(run.sfm.keypoints.descriptors.shape[-1] == 512, "AKAZE descriptors are not 512 wide")

    d = rec["dense"]
    _require(d["depth_coverage"] >= 0.30, f"AKAZE dense coverage {d['depth_coverage']} < 0.30")
    _require(d["sparse_depth_med_rel_err"] < 0.02, f"AKAZE dense error {d['sparse_depth_med_rel_err']}")
    _require(
        abs(d["n_dense_points"] - REF_AKAZE["dense_points"]) <= 0.2 * REF_AKAZE["dense_points"],
        f"{d['n_dense_points']} dense points, not within 20% of {REF_AKAZE['dense_points']}",
    )
    flt, mesh, seg = rec["filter"], rec["mesh"], rec["segment"]
    _require(0 < flt["n_after"] <= flt["n_before"] == d["n_dense_points"], f"filter: {flt}")
    _require(mesh["n_faces"] > 0, "mesh has no faces")
    _require(seg["n_clusters"] >= 1, "segmentation found no cluster (the reference finds 2)")

    # Every artifact reads back with the counts the metrics state.
    sparse, _ = read_ply(os.path.join(out, "sparse.ply"))
    dense, _ = read_ply_fast(os.path.join(out, "dense.ply"))
    pcd, _ = read_pcd(os.path.join(out, "MAP3D.pcd"))
    filtered, _ = read_ply(os.path.join(out, "filtered.ply"))
    labels = np.load(os.path.join(out, "segmentation_labels.npy"))
    with open(os.path.join(out, "dendrometry.json")) as f:
        rep = json.load(f)
    with open(os.path.join(out, "mesh.obj")) as f:
        obj = f.read().split("\n")
    verts = np.array([l.split()[1:] for l in obj if l.startswith("v ")], np.float64)
    n_faces = sum(l.startswith("f ") for l in obj)
    _require(len(sparse) == m["n_points"], "sparse.ply count")
    _require(len(dense) == len(pcd) == d["n_dense_points"], "dense.ply / MAP3D.pcd count")
    _require(len(filtered) == len(labels) == flt["n_after"] == rep["n_points"], "filtered cloud count")
    _require(n_faces == mesh["n_faces"] and len(verts) == mesh["n_vertices"], "mesh.obj count")
    _require(np.isfinite(verts).all(), "mesh vertices are not finite")
    _require(int((np.unique(labels) >= 0).sum()) == seg["n_clusters"], "label / cluster count")
    _require(os.path.exists(ckpt) and os.path.exists(ckpt_cut), "checkpoint files missing")
    print(
        "AKAZE V=10 (CLI) artifacts: dense %d points (reference %d), coverage %.3f, "
        "sparse-depth error %.4f; filter %d -> %d (reference -> %d); mesh %d vertices, %d "
        "faces (reference %d faces); %d clusters (reference %d); total height %.3f "
        "(reference %.3f); all 9 files read back"
        % (
            d["n_dense_points"], REF_AKAZE["dense_points"], d["depth_coverage"],
            d["sparse_depth_med_rel_err"], flt["n_before"], flt["n_after"],
            REF_AKAZE["filter_after"], mesh["n_vertices"], mesh["n_faces"], REF_AKAZE["mesh_faces"],
            seg["n_clusters"], REF_AKAZE["n_clusters"], rep["total_height"], REF_AKAZE["total_height"],
        )
    )
    row = check_knn2_on_run("AKAZE run's descriptors", run.sfm, cfg)
    return run, launches, (out, ckpt, ckpt_cut), row


def run_resume(scene, workdir, run8, paths):
    """Phase 9: both resume paths from phase 8's checkpoints."""
    from sfm_danpipeline_torch import cli
    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline

    cfg = _cli_config("akaze")
    out8, ckpt, ckpt_cut = paths
    out = os.path.join(workdir, "out_resume")
    run, la = _count_launches(lambda: cli.run_stages(
        scene.images, scene.intrinsics, cfg, out, ["dense", "segment", "dendrometry"],
        device="cuda", checkpoint=ckpt,
    ))
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rec = {r["stage"]: r for r in map(json.loads, f)}
    _require("sfm" not in rec and run.sfm is None, "resume (a) ran the sfm stage")
    _require(run.state.device.type == "cuda", "resume (a): the loaded state is not on the card")
    _require(
        rec["dense"]["n_dense_points"] == run8.dense.metrics["n_dense_points"],
        f"resume (a): {rec['dense']['n_dense_points']} dense points, phase 8 had "
        f"{run8.dense.metrics['n_dense_points']}",
    )
    _require(la["knn2"] == 0, "resume (a) launched knn2")
    print(
        "resume (a): stages dense,segment,dendrometry from the checkpoint: state on %s, "
        "%d dense points (phase 8: %d), %d clusters, exit code %d"
        % (
            run.state.device, rec["dense"]["n_dense_points"],
            run8.dense.metrics["n_dense_points"], rec["segment"]["n_clusters"], run.code,
        )
    )

    with np.load(ckpt_cut) as z:
        n_cut = len(z["extra_done"])
    res, lb = _count_launches(
        lambda: SfMPipeline(cfg, checkpoint_path=ckpt_cut, device="cuda").run(scene.images, scene.intrinsics)
    )
    m8, m = run8.sfm.metrics, res.metrics
    bitwise = (
        torch.equal(res.state.cameras, run8.sfm.state.cameras)
        and torch.equal(res.state.points_xyz, run8.sfm.state.points_xyz)
    )
    print(
        "resume (b): from the checkpoint at %d views: registered %s, RMS %.6f px, %d points; "
        "uninterrupted run: RMS %.6f px, %d points; final cameras and points %s"
        % (
            n_cut, res.registered_views, m["ba_rms_px"], m["n_points"], m8["ba_rms_px"],
            m8["n_points"], "equal bit for bit" if bitwise else "NOT equal bit for bit",
        )
    )
    _require(n_cut == RESUME_AT_VIEWS, f"the cut checkpoint holds {n_cut} views")
    _require(res.registered_views == run8.sfm.registered_views, "resume (b): registered set differs")
    _require(bitwise, "resume (b): the final cameras or points differ from the uninterrupted run's")
    return {"knn2": la["knn2"] + lb["knn2"]}


def run_frontend(tag, detector, matcher, ring_fraction, ref, knn2_launches, seed=0):
    """Phase 10: SfMPipeline with another detector or matcher at V=10.
    Returns (result, config, launches, ATE in % of the diameter)."""
    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline

    scene = courtyard(10, ring_fraction)
    cfg = _cli_config(detector, matcher)
    cfg = dataclasses.replace(cfg, geometry=dataclasses.replace(cfg.geometry, seed=seed))
    res, launches = _count_launches(
        lambda: SfMPipeline(cfg, device="cuda").run(scene.images, scene.intrinsics)
    )
    m = res.metrics
    ate_frac = ate_fraction(scene, res.state.cameras.cpu().numpy(), res.registered_views)
    _print_run(tag, m, ate_frac, ref)
    _require(m["n_registered"] == 10, f"{tag}: registered {m['n_registered']}/10")
    _require(m["ba_rms_px"] < 1.0, f"{tag}: BA RMS {m['ba_rms_px']} px >= 1")
    _require(np.isfinite(res.points).all() and len(res.points) > 0, f"{tag}: bad sparse cloud")
    _require(
        launches["knn2"] == knn2_launches,
        f"{tag}: knn2 launched {launches['knn2']} times, expected {knn2_launches}",
    )
    print(f"{tag}: knn2 launches {launches['knn2']}")
    return res, cfg, launches, 100 * ate_frac


def run_flow_seeds():
    """Phase 10, flow: one run per seed of FLOW_SEEDS, each held as any
    front end is; the median ATE is held to the reference's distribution."""
    launches, ates = {"knn2": 0}, []
    for seed in FLOW_SEEDS:
        _, _, la, ate = run_frontend(
            f"flow V=10 seed {seed}", "sift", "flow", 0.05, REF_FLOW, knn2_launches=0, seed=seed
        )
        launches["knn2"] += la["knn2"]
        ates.append(ate)
    worst = max(REF_FLOW_SEED_ATE_PCT.values())
    print(
        "flow V=10 over seeds %s: ATE %s%%, median %.4f%%; reference (JAX, CPU) over seeds "
        "0-5: %s, no seed pair at seeds %s"
        % (
            list(FLOW_SEEDS), ", ".join("%.4f" % a for a in ates), np.median(ates),
            ", ".join("seed %d %.3f%%" % kv for kv in REF_FLOW_SEED_ATE_PCT.items()),
            list(REF_FLOW_SEEDS_FAILED),
        )
    )
    _require(
        np.median(ates) <= worst,
        f"flow: median ATE {np.median(ates)}% over seeds {FLOW_SEEDS} passes the reference's worst {worst}%",
    )
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}"
    )

    if sys.argv[1:]:
        raise SystemExit("usage: chip_smoke.py (no arguments)")

    from sfm_danpipeline_torch import kernels

    t_script = time.time()
    t0 = time.time()
    kernels.load("knn2")  # nvcc from csrc/ at first use
    print(f"build: knn2 {time.time() - t0:.1f}s")
    print("".join(f"  {line}\n" for line in kernels.ptxas_report("knn2")), end="")
    knn2_row = check_knn2()
    launches = {}
    scene10, res10, l4 = run_pipeline(10, 0.2, components=1)
    scene20, res20, l5 = run_pipeline(20, 0.4, components=2)
    l6 = run_dense(scene20, res20)
    del scene20, res20
    check_repeatability(scene10, res10)
    with tempfile.TemporaryDirectory() as workdir:
        run8, l8, paths, row512 = run_cli_akaze(scene10, workdir)
        l9 = run_resume(scene10, workdir, run8, paths)
    res_orb, cfg_orb, l10a, _ = run_frontend("ORB V=10", "orb", "bf", 0.2, REF_ORB, knn2_launches=1)
    row256 = check_knn2_on_run("ORB run's descriptors", res_orb, cfg_orb)
    l10b = run_flow_seeds()
    for part in (l4, l5, l6, l8, l9, l10a, l10b):
        for name, n in part.items():
            launches[name] = launches.get(name, 0) + n
    print(f"chip_smoke: all phases in {time.time() - t_script:.0f}s")
    print(json.dumps({"kernels": [{
        "name": "knn2",
        "route": "cuda",
        "source": "sfm_danpipeline_torch/csrc/knn2.cu",
        "replaces": "sfm_danpipeline_tpu/ops/matching.py:182",
        "launches": launches["knn2"],
        **knn2_row,
        # The same kernel on real binary descriptors, every pair of a run.
        "real_descriptor_shapes": [
            {"detector": "akaze", "d": 512, **row512}, {"detector": "orb", "d": 256, **row256},
        ],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
