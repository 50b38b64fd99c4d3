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
     image pair, the RANSAC pose twice from one key, a BA step twice from
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
     descriptors, held and timed) and with the LK-flow matcher over the
     reference's RANSAC seeds 0-5, which launches no kernel, each seed's
     outcome printed beside the reference's;
 11. in-process sharding on the card: match_all_pairs_sharded over
     [cuda:0] * 4 on the V=10 run's keypoints (45 pairs, no multiple of 4),
     equal bit for bit to the unsharded call, and run_ba_sharded with 4
     shards on the V=10 final problem against the one-device solve;
 12. two ranks on the one card: two processes of the command line with
     --coordinator / --num-processes / --process-id (gloo, since NCCL takes
     one rank per card) on the V=10 control scene written as PNG files, the
     polish forced on (--sharded-min-obs 16): both ranks exit 0 with equal
     digests, 10/10, RMS < 1 px, ATE < 1%, polish cost not increased;
 13. guided bridging: SfMPipeline on the V=20 arc with
     geometry.guided_enable, held to the reference's registered-view count,
     with its guided registrations, block realign and the basin it takes
     at view 11 printed beside the reference's seed-0 outcome;
 14. pair scoring and the all-pairs epipolar prefilter, each one batched
     call over the V=10 run's 45 pairs on the pipeline's keyed draws, held
     pair by pair against the one-pair calls on the same draws: masks,
     flags and counts equal, R and t within 1e-6 (the bound
     tests/test_torch_pairs.py states); the mask entries that differ and
     the largest R and t gaps are printed with both forms' times;
 15. the random draws (ops/prng.py, the reference's threefry key tree):
     one scoring key batch, the prefilter's batch and one PnP call's draws
     through sample_indices, each drawn on the card and on the CPU from the
     same keys and held equal bit for bit, with each one's time with its
     key on the card and on the host;
 16. the 50-view closed ring (1,225 pairs, the default config), the size
     users run: SfMPipeline.run at the reference's geometry seeds 0-2, each
     seed's stage times, t_baseline's split, registered views, RMS, points,
     ATE and rotavg_applied printed beside the reference's CPU numbers and
     held to the gates the reference meets at that seed; then knn2 at the
     ring's shape (P = 1,225, D = 128) on the seed-0 run's own descriptors,
     held against knn2_torch (in slices of pairs) with indices equal on
     every row the matcher keeps and near-ties elsewhere, and timed;

Phases 4 and 5 also print t_baseline's split: pair scoring, the prefilter,
the seed bootstrap (`_try_seed`) and the rest, each timed by wrapping the
function with synchronized wall clocks here (the pipeline's metrics are
the reference's).

then the kernel summary line (launches summed over every phase, the rank
processes included), and as the last line the device record
{"ok": true, "device": {...}}.

Phase 13 runs in a process of its own beside phases 4-7, and the flow runs
of phase 10 and phase 16's runs in two more beside phase 12 (the runs are
host-bound; no kernel is timed while another process runs); their lines
are printed when they end. Phase 16's kernel check runs in this
process after every child has ended.

One-off measurements (stage timings of two commits, the determinism audit,
the flow path over RANSAC seeds) are in tools/torch_stage_probe.py.
"""
import dataclasses
import functools
import json
import logging
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
# The flow path over RANSAC seeds 0-5 in the reference
# (`tools/reference_flow_seeds.py`, CPU runs): the narrow arc is marginal for
# it (only adjacent views share more than ~150 flow matches, 1.8 degrees
# apart), so three seeds find no seed pair and the other three end at these
# trajectory errors (% of the diameter) and final RMS. The port draws the
# reference's samples from each seed (ops/prng.py) and runs the same seeds:
# at least as many of them as in the reference must register every view,
# and the median ATE of those must not pass the reference's worst. Which
# seeds succeed is not fixed by the draws alone on this scene: on
# near-degenerate samples the 8-point fits' null vector follows float32
# rounding (the order A^T A is summed in, and the eigh), which differs per
# package and per device (PERF.md).
REF_FLOW_SEED_ATE_PCT = {0: 1.231, 1: 2.007, 4: 12.905}
REF_FLOW_SEED_RMS_PX = {0: 0.842, 1: 0.818, 4: 1.143}
REF_FLOW_SEEDS_FAILED = (2, 3, 5)
FLOW_SEEDS = tuple(range(6))
RESUME_AT_VIEWS = 6
# The JAX reference's SfMPipeline on the V=20 arc with
# geometry.guided_enable=True (`JAX_PLATFORMS=cpu python3
# tools/guided_arc.py`, on a CPU): views 11-13 register by the guided
# bridge, 14 by plain PnP; the guided block's realign finds no Sim(3) (2
# inliers of 26 candidates), and views 15-19 form a second component that
# does not merge: 15/20 registered, RMS 0.206 px, 1,685 points, ATE 28.38%
# of the diameter (the guided chain lands in a wrong basin, which is why
# guided bridging is off by default). The port must register at least as
# many views, at least one of them guided, with RMS < 1 px; its guided
# counts, ATE and the basin the guided bridge takes at view 11 (its
# anchored-match counts) are printed beside these. The outcome follows the
# RANSAC draws (`tools/guided_arc.py --seed`, CPU runs over seeds 0-4: the
# reference registers 15, 20, 15, 20, 20 views, taking at view 11 the basin
# with 39, 144, 145, 144, 39 anchored matches).
REF_GUIDED = {
    "n_registered": 15, "n_guided_registered": 3, "block_realign_applied": None,
    "ba_rms_px": 0.206, "n_points": 1685, "ate_pct": 28.38, "view11_basin_matches": 39,
}
# Phase 16: the closed ring make_courtyard_scene(n_views=50,
# ring_fraction=1.0, seed=0), 480x640, 2,048 SIFT keypoints, the default
# config, at geometry seeds 0-2. The reference's SfMPipeline on this scene
# at each seed (`JAX_PLATFORMS=cpu python3 tools/seed_parity.py ring
# --package reference --seeds S`, CPU runs, XLA's default threads):
# registered views, final BA RMS, points, ATE in % of the diameter,
# rotavg_applied and the registration keys taken. Which secondary component
# merges, and so which views register, follows float32 rounding on this
# ring, in the reference too: with XLA's CPU threads at one, the reference
# ends seeds 0 and 2 at 5,223 and 4,992 points, RMS 0.1855 and 0.1851 px,
# ATE 0.1228% and 0.1218%, and seed 1 at 6,619 points, RMS 0.6535 px, ATE
# 20.77% (PERF.md section 4).
RING_VIEWS, RING_SEEDS = 50, (0, 1, 2)
REF_RING = {
    0: {"registered": list(range(11, 43)), "ba_rms_px": 0.1844, "n_points": 5222,
        "ate_pct": 0.1213, "rotavg_applied": 0.0, "key_n": 193},
    # The ring closes on a wrong trajectory in the reference at seed 1.
    1: {"registered": list(range(0, 14)) + list(range(15, 43)) + [49], "ba_rms_px": 0.1855,
        "n_points": 6172, "ate_pct": 18.2675, "rotavg_applied": None, "key_n": 199},
    2: {"registered": list(range(11, 22)) + list(range(23, 43)), "ba_rms_px": 0.1856,
        "n_points": 4993, "ate_pct": 0.1252, "rotavg_applied": 0.0, "key_n": 152},
}
# Each gate the reference meets at a seed holds the port there: the same
# number of registered views, RMS < 1 px, points within RING_POINTS_RTOL of
# the reference's, ATE < 1%. A seed where the two part by float rounding
# (its witness in ROADMAP Queue 3, "V=50 ring") is printed as such and held
# to RMS and to at least RING_CORE_MIN of the core views RING_CORE: the
# views 11-42 between the seed pair's component and component (2, 3), of
# which every run of either package (CPU or card, its own front end or the
# reference's, XLA's default threads or one) registered 30-32 at each seed
# (PERF.md section 4); which of the other views join follows whether
# component (2, 3) merges, and that flips on rounding. Seed 1's witness: the
# reference merges component (2, 3) there and closes the ring on a wrong
# trajectory (43 views, ATE 18.3%), the port on the card drops it and ends
# on a wrong trajectory too (31 views, ATE 19.1%), and the port's merge step
# fed the reference's inputs to it merges as the reference's does
# (`tools/seed_parity.py merge-step --seed 1`).
RING_ROUNDING_SEEDS = {1: "a wrong trajectory in the reference too"}
RING_CORE, RING_CORE_MIN = range(11, 43), 30
RING_POINTS_RTOL = 0.01
RING_KEYPOINTS = "ring_keypoints.pt"
# The counters of the port's departures from the reference, printed per run.
DEPARTURES = ("pnp_reselect_taken", "blind_views_swept", "seeds_loop_rejected")
RING_DECISIONS = ("seed (", "merging", "component", "straggler", "global reinit", "rotavg")
# Phase 12: the multi-process run's scene and the polish threshold that
# forces the observation-sharded polish at this size.
MH_VIEWS, MH_RING = 10, 0.2
MH_SHARDED_MIN_OBS = 16
MH_TIMEOUT_S = 420
# Phases run in a process of their own beside the main sequence, with the
# most each may take: the pipeline runs are host-bound (the card idles > 90%
# of a run), so two of them side by side end in about the time of one.
CHILD_TIMEOUT_S = {"guided": 600, "flow": 600, "ring": 900}
# Phase 14: the batched pair calls against the one-pair calls on the same
# draws (tests/test_torch_pairs.py's bound).
PAIR_BATCH_RT_ATOL = 1e-6
CHILD_MARK = "chip_smoke child launches: "


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


def check_knn2_case(name, case, exact_idx=False, timed=False, kept_ratio=None):
    """One input set through the kernel and through its plain version on the
    card (knn2_torch in slices of pairs, knn2_torch_sliced: the ring's
    1,225 pairs at once would hold 20.6 GB of distances), held to
    KNN2_RTOL / KNN2_ATOL / KNN2_TIE (or to equal indices). Prints one
    line; returns the numbers of the kernels line when `timed`. With
    `kept_ratio` the indices must be equal on every row the matcher keeps at
    that Lowe ratio in either result (a valid A row with a second best and
    d1 <= ratio * d2): elsewhere the index is never read."""
    from sfm_danpipeline_torch.ops.matching import _launch_knn2, knn2, knn2_torch_sliced
    from sfm_danpipeline_torch.utils.knn_cases import compare_knn2, to_tensors

    desc, valid, xy, pi, pj = to_tensors(case, "cuda")
    pil, pjl = pi.long(), pj.long()
    n, k, d = desc.shape

    def plain():
        return knn2_torch_sliced(desc, valid, xy, pi, pj, case.dup_r2)

    def kernel():
        return knn2(desc, valid, xy, pi, pj, case.dup_r2)

    got = kernel()
    torch.cuda.synchronize()  # a fault during the run surfaces here
    flagged = int(knn2.last_flagged)
    ref = plain()
    n_mism, max_err = compare_knn2(
        got, ref, desc, valid, pi, pj,
        rtol=KNN2_RTOL, atol=KNN2_ATOL, tie=KNN2_TIE, exact_idx=exact_idx,
    )
    line = (
        f"knn2 {name}: P={pi.numel()} Ka=Kb={k} D={d} dup_r2={case.dup_r2}: "
        f"{n_mism} index mismatches ({'none allowed' if exact_idx else 'all near-ties'}), "
        f"max |d2 err| {max_err:.3e} (rtol {KNN2_RTOL}, atol {KNN2_ATOL}); "
        f"second sweep took {flagged} of {pi.numel() * k} rows"
    )
    if kept_ratio is not None:
        valid_a = valid[pil]

        def kept(r):
            return valid_a & (r[2] < 3.4e38) & (r[1].sqrt() <= kept_ratio * r[2].sqrt())

        rows = kept(got) | kept(ref)
        mism = got[0] != ref[0]
        n_kept = int((mism & rows).sum())
        line += (
            f"; of the mismatches {int((mism & ~valid_a).sum())} on invalid A rows, "
            f"{n_kept} on the {int(rows.sum())} rows the matcher keeps at ratio {kept_ratio} "
            "(none allowed)"
        )
        _require(n_kept == 0, f"knn2 {name}: {n_kept} index mismatches on rows the matcher keeps")
    del ref
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
            f"knn2_torch_sliced {ms_p:.3f} ms, bound "
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


class _BaselineSplit:
    """Times the parts of t_baseline inside one SfMPipeline.run by wrapping
    pair scoring, the prefilter and the seed bootstrap with synchronized
    wall clocks. `_try_seed` also seeds secondary components after the
    baseline stage; only its first call is inside t_baseline."""

    def __init__(self):
        from sfm_danpipeline_torch.pipeline import sfm

        self.sfm = sfm
        self.times = {"scoring": [], "prefilter": [], "seed": []}
        self.saved = {}

    def _wrap(self, owner, attr, key):
        fn = getattr(owner, attr)
        self.saved[(owner, attr)] = fn

        @functools.wraps(fn)
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.times[key].append(time.perf_counter() - t0)
            return out

        setattr(owner, attr, timed)

    def __enter__(self):
        self._wrap(self.sfm, "score_pairs", "scoring")
        self._wrap(self.sfm, "epipolar_prefilter_table", "prefilter")
        self._wrap(self.sfm.SfMPipeline, "_try_seed", "seed")
        return self

    def __exit__(self, *exc):
        for (owner, attr), fn in self.saved.items():
            setattr(owner, attr, fn)

    def split(self, t_baseline):
        """{part: seconds} of one run's t_baseline, the rest included."""
        parts = {k: v[0] if v else 0.0 for k, v in self.times.items()}
        parts["rest"] = t_baseline - sum(parts.values())
        return parts


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
    with _BaselineSplit() as timer:
        res, launches = _count_launches(lambda: pipe.run(scene.images, scene.intrinsics))
    m = res.metrics
    ate_frac = ate_fraction(scene, res.state.cameras.cpu().numpy(), res.registered_views)
    stages = {k: round(v, 3) for k, v in m.items() if k.startswith("t_")}
    print(f"V={n_views} stages (s): {json.dumps(stages)}")
    _print_departures(f"V={n_views}", res)
    split = timer.split(m["t_baseline"])
    print(
        "V=%d t_baseline %.3f s: pair scoring %.3f s, prefilter %.3f s, seed bootstrap "
        "(_try_seed) %.3f s, rest %.3f s (%d pairs)"
        % (n_views, m["t_baseline"], split["scoring"], split["prefilter"], split["seed"],
           split["rest"], m["n_pairs"])
    )
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
    from sfm_danpipeline_torch.ops import prng
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
        return estimate_relative_pose(
            prng.key(0, device="cuda"), x1, x2, m.valid, focal=scene.intrinsics.fx
        )

    first = pose()
    _bit_equal("RANSAC pose", tuple(first), tuple(pose()))
    _require(bool(first.ok), "repeatability: the RANSAC pose of views 0-1 failed")
    print(
        f"repeatability: RANSAC pose twice from one key ({int(m.valid.sum())} matches, "
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


def _pipeline_keys(n_pairs, device):
    """The keys SfMPipeline.run gives scoring (per pair: essential and
    homography) and the prefilter (per pair) at geometry.seed 0."""
    from sfm_danpipeline_torch.ops import prng

    root = prng.key(0, device=device)
    k_score = prng.split(root, 2)[0]
    k_e, k_h = prng.split(prng.split(k_score, n_pairs), 2).unbind(-2)
    return k_e, k_h, prng.split(prng.fold_in(root, 0x9E1F), n_pairs)


def check_pair_batch(scene, res):
    """Phase 14: pair scoring and the prefilter as one batched call each on
    the V=10 run's matches, against the one-pair calls on the same draws.
    Returns the strict and loose matches (phase 15 draws over them)."""
    from sfm_danpipeline_torch.config import PipelineConfig
    from sfm_danpipeline_torch.ops.matching import match_all_pairs
    from sfm_danpipeline_torch.ops.ransac import sample_indices
    from sfm_danpipeline_torch.pipeline.bootstrap import score_pair, score_pairs
    from sfm_danpipeline_torch.pipeline.incremental import (
        epipolar_filter_matches,
        epipolar_prefilter_table,
    )

    cfg = PipelineConfig()
    g = cfg.geometry
    kp = res.keypoints
    V = kp.valid.shape[0]
    pi, pj = (torch.as_tensor(a, dtype=torch.int32, device="cuda") for a in np.triu_indices(V, 1))
    matches = match_all_pairs(
        kp.descriptors, kp.valid, pi, pj,
        ratio=max(cfg.matching.ratio, cfg.matching.registration_ratio),
        max_matches=cfg.matching.max_matches, strict_ratio=cfg.matching.ratio, xy=kp.xy,
        dup_radius=cfg.matching.dup_radius, dedup=cfg.matching.dedup_matches,
    )
    strict = matches.at_ratio(cfg.matching.ratio)
    K = torch.as_tensor(scene.intrinsics.K, dtype=torch.float32, device="cuda")
    dist = torch.as_tensor(scene.intrinsics.dist, dtype=torch.float32, device="cuda")
    max_dim = float(max(scene.images.shape))
    k_e, k_h, k_p = _pipeline_keys(len(pi), "cuda")
    draws = (
        sample_indices(k_e, strict.valid, g.essential_ransac_iters, 8),
        sample_indices(k_h, strict.valid, g.homography_ransac_iters, 4),
    )
    draws_p = sample_indices(k_p, matches.valid, g.prefilter_ransac_iters, 8)
    xy = kp.xy

    def batched():
        sc = score_pairs(None, strict, xy, pi, pj, K, dist, max_dim, cfg, samples=draws)
        tab = epipolar_prefilter_table(
            None, matches.idx_a, matches.idx_b, matches.valid, xy, pi, pj, K, dist, cfg, V,
            samples=draws_p,
        )
        return sc, tab

    def one_pair_calls():
        outs, filt = [], []
        for p, (i, j) in enumerate(zip(pi.tolist(), pj.tolist())):
            m = strict.pair(p)
            outs.append(score_pair(
                None, m, xy[i][m.idx_a.long()], xy[j][m.idx_b.long()], K, dist, max_dim, cfg,
                samples=(draws[0][p], draws[1][p]),
            ))
            loose = matches.pair(p)
            filt.append(epipolar_filter_matches(
                None, xy[i][loose.idx_a.long()], xy[j][loose.idx_b.long()], loose.valid, K,
                dist, cfg, samples=draws_p[p],
            ))
        return outs, filt

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc, tab = batched()
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs, filt = one_pair_calls()
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    ratio, n, usable, h_over_e, R, t, n_inl = (torch.stack([o[k] for o in outs]) for k in range(7))
    flags_differ = int(
        (usable != sc.usable).sum() + (n.to(torch.int32) != sc.n_matches).sum()
        + (n_inl.to(torch.int32) != sc.n_inliers).sum() + (h_over_e != sc.h_over_e).sum()
        + (torch.where(usable, ratio, -1.0) != sc.pose_inlier_ratio).sum()
    )
    rows = tab[pi.long(), pj.long()]
    mask_differ = int((torch.stack(filt) != rows).sum())
    r_gap = float((R - sc.R_rel).abs().max())
    t_gap = float((t - sc.t_rel).abs().max())
    print(
        "pair batch: %d pairs, scoring + prefilter batched %.3f s, one-pair calls %.3f s; "
        "prefilter mask entries differing %d of %d, scoring flags/counts differing %d, "
        "largest |R| gap %.3g, largest |t| gap %.3g (bound %g); %d usable pairs"
        % (len(pi), t_batch, t_one, mask_differ, rows.numel(), flags_differ, r_gap, t_gap,
           PAIR_BATCH_RT_ATOL, int(sc.usable.sum()))
    )
    _require(mask_differ == 0 and flags_differ == 0, "pair batch: masks or counts differ")
    _require(
        r_gap <= PAIR_BATCH_RT_ATOL and t_gap <= PAIR_BATCH_RT_ATOL,
        f"pair batch: R / t gap {r_gap} / {t_gap} > {PAIR_BATCH_RT_ATOL}",
    )
    return strict, matches


def check_draws(strict, matches):
    """Phase 15: the keyed draws on the card equal those on the CPU, bit
    for bit, at the pipeline's shapes (the V=10 run's scoring and prefilter
    batches and one PnP call's draws), and what each costs with its key on
    the card and on the host (the random words are hashed where the key
    lies and folded where the mask lies)."""
    from sfm_danpipeline_torch.config import PipelineConfig
    from sfm_danpipeline_torch.ops import prng
    from sfm_danpipeline_torch.ops.pnp import pnp_sample_draws
    from sfm_danpipeline_torch.ops.ransac import sample_indices

    g = PipelineConfig().geometry
    n_pairs = strict.valid.shape[0]
    keys = {dev: _pipeline_keys(n_pairs, dev) for dev in ("cuda", "cpu")}
    # One registration's PnP draws: the run's first registration key, over
    # pair 0's strict matches as the rows and every third one as strict.
    k_reg = {
        dev: prng.split(prng.split(prng.key(0, device=dev), 2)[1], 10 * 32)[0]
        for dev in ("cuda", "cpu")
    }
    rows = strict.valid[0]
    sub = rows & (torch.arange(rows.numel(), device=rows.device) % 3 == 0)
    cases = {
        "scoring essential (%d x %d x 8)" % (n_pairs, g.essential_ransac_iters):
            lambda kd, vd: sample_indices(keys[kd][0], strict.valid.to(vd), g.essential_ransac_iters, 8),
        "scoring homography (%d x %d x 4)" % (n_pairs, g.homography_ransac_iters):
            lambda kd, vd: sample_indices(keys[kd][1], strict.valid.to(vd), g.homography_ransac_iters, 4),
        "prefilter (%d x %d x 8)" % (n_pairs, g.prefilter_ransac_iters):
            lambda kd, vd: sample_indices(keys[kd][2], matches.valid.to(vd), g.prefilter_ransac_iters, 8),
        "one PnP call (3 draws)": lambda kd, vd: torch.cat([
            d.reshape(-1)
            for d in pnp_sample_draws(k_reg[kd], rows.to(vd), g.pnp_ransac_iters, 6, sub.to(vd))
        ]),
    }
    for name, fn in cases.items():
        on_cpu = fn("cpu", "cpu")
        equal = torch.equal(fn("cuda", "cuda").cpu(), on_cpu) and torch.equal(fn("cpu", "cuda").cpu(), on_cpu)
        t_card = _median_ms(lambda: fn("cuda", "cuda"))
        t_host = _median_ms(lambda: fn("cpu", "cuda"))
        print(
            "draws, %s: card and CPU %s (%d indices); %.3f ms with the key on the card, "
            "%.3f ms with it on the host (mask on the card)"
            % (name, "equal bit for bit" if equal else "DIFFER", on_cpu.numel(), t_card, t_host)
        )
        _require(equal, f"draws, {name}: the card's draws differ from the CPU's")


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


def _print_departures(tag, res):
    """The run's counts of the port's departures from the reference
    (ROADMAP.md, known defects of the reference): where each is 0 the run
    took the reference's decisions."""
    counters = res.trace["counters"]
    print(f"{tag} departures: " + ", ".join(f"{k} {counters.get(k, 0)}" for k in DEPARTURES))


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

    def save_and_copy(self, state, done, anchor):
        save(self, state, done, anchor)
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
    _print_departures("AKAZE V=10 (CLI)", run.sfm)
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
    _print_departures(tag, res)
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
    """Phase 10, flow: one run per seed of FLOW_SEEDS, the reference's
    seeds, each seed's outcome printed beside the reference's. A seed either
    finds no seed pair (as three of the reference's do) or registers views;
    at least as many seeds as in the reference must register every view,
    each of those is held as any front end is (RMS < 1 px, a finite cloud,
    no kNN launch), and their median ATE is held to the reference's worst.
    Every seed runs before the gates are read."""
    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline

    scene = courtyard(10, 0.05)
    base = _cli_config("sift", "flow")
    launches, runs = {"knn2": 0}, {}
    for seed in FLOW_SEEDS:
        cfg = dataclasses.replace(base, geometry=dataclasses.replace(base.geometry, seed=seed))
        try:
            res, la = _count_launches(
                lambda: SfMPipeline(cfg, device="cuda").run(scene.images, scene.intrinsics)
            )
        except RuntimeError as e:
            if "baseline reconstruction failed" not in str(e):
                raise
            runs[seed] = None
            continue
        launches["knn2"] += la["knn2"]
        ate_frac = ate_fraction(scene, res.state.cameras.cpu().numpy(), res.registered_views)
        _print_run(f"flow V=10 seed {seed}", res.metrics, ate_frac, REF_FLOW)
        _print_departures(f"flow V=10 seed {seed}", res)
        runs[seed] = dict(
            n=res.metrics["n_registered"], rms=res.metrics["ba_rms_px"], ate=100 * ate_frac,
            finite=bool(np.isfinite(res.points).all() and len(res.points) > 0), knn2=la["knn2"],
        )
    for seed in FLOW_SEEDS:
        r = runs[seed]
        port = "no seed pair" if r is None else "%d/10, RMS %.3f px, ATE %.3f%%" % (r["n"], r["rms"], r["ate"])
        ref = (
            "%d/10, RMS %.3f px, ATE %.3f%%" % (10, REF_FLOW_SEED_RMS_PX[seed], REF_FLOW_SEED_ATE_PCT[seed])
            if seed in REF_FLOW_SEED_ATE_PCT
            else "no seed pair" if seed in REF_FLOW_SEEDS_FAILED else "not run"
        )
        print(f"flow V=10 seed {seed}: port {port}; reference (JAX, CPU) {ref}")
    complete = {s: r for s, r in runs.items() if r is not None and r["n"] == 10}
    worst = max(REF_FLOW_SEED_ATE_PCT.values())
    median = float(np.median([r["ate"] for r in complete.values()])) if complete else float("inf")
    print(
        "flow V=10 over seeds %s: %d register every view (reference %d), median ATE %.4f%% "
        "(reference's worst %.3f%%), knn2 launches %d"
        % (list(FLOW_SEEDS), len(complete), len(REF_FLOW_SEED_ATE_PCT), median, worst, launches["knn2"])
    )
    _require(
        len(complete) >= len(REF_FLOW_SEED_ATE_PCT),
        f"flow: {len(complete)} seeds of {list(FLOW_SEEDS)} register every view, the reference "
        f"{len(REF_FLOW_SEED_ATE_PCT)}",
    )
    for seed, r in complete.items():
        _require(r["rms"] < 1.0, f"flow V=10 seed {seed}: BA RMS {r['rms']} px >= 1")
        _require(r["finite"], f"flow V=10 seed {seed}: bad sparse cloud")
    _require(launches["knn2"] == 0, f"flow: knn2 launched {launches['knn2']} times")
    _require(median <= worst, f"flow: median ATE {median}% passes the reference's worst {worst}%")
    return launches


def check_sharding(scene, res10, cfg):
    """Phase 11: the in-process sharded matcher and BA over [cuda:0] * 4.
    Returns the sharded matcher's launch counts."""
    from sfm_danpipeline_torch.ba.problem import BAProblem
    from sfm_danpipeline_torch.ba.sharded import run_ba_sharded
    from sfm_danpipeline_torch.ba.solver import run_ba
    from sfm_danpipeline_torch.ops.matching import match_all_pairs
    from sfm_danpipeline_torch.parallel.matching import match_all_pairs_sharded
    from sfm_danpipeline_torch.pipeline.tracks import observation_table_compact

    shards = [torch.device("cuda", 0)] * 4
    kp = res10.keypoints
    n = kp.valid.shape[0]
    pi, pj = (torch.as_tensor(a, dtype=torch.int32, device="cuda") for a in np.triu_indices(n, 1))
    kw = dict(
        ratio=max(cfg.matching.ratio, cfg.matching.registration_ratio),
        max_matches=cfg.matching.max_matches, strict_ratio=cfg.matching.ratio, xy=kp.xy,
        dup_radius=cfg.matching.dup_radius, dedup=cfg.matching.dedup_matches,
    )
    got, launches = _count_launches(
        lambda: match_all_pairs_sharded(kp.descriptors, kp.valid, pi, pj, devices=shards, **kw)
    )
    plain = match_all_pairs(kp.descriptors, kp.valid, pi, pj, **kw)
    equal = all(
        torch.equal(getattr(got, f), getattr(plain, f))
        for f in ("idx_a", "idx_b", "valid", "dist", "lowe")
    )
    print(
        "sharding: match_all_pairs_sharded over [cuda:0] x 4, P=%d (padded to %d), K=%d, D=%d: "
        "%d valid matches, every field %s the unsharded call's; knn2 launches %d"
        % (
            pi.numel(), -(-pi.numel() // 4) * 4, kp.valid.shape[1], kp.descriptors.shape[-1],
            int(got.valid.sum()), "equal bit for bit to" if equal else "DIFFERENT from",
            launches["knn2"],
        )
    )
    _require(equal, "sharded matching differs from the unsharded call")
    _require(launches["knn2"] == 4, f"sharded matching launched knn2 {launches['knn2']} times, not 4")

    # The V=10 final problem with its points shaken as in phase 7, so that
    # both solves descend over their whole budget.
    st = res10.state
    B = int(st.n_points)
    pp = torch.tensor([scene.intrinsics.cx, scene.intrinsics.cy], dtype=torch.float32, device="cuda")
    obs_cam, obs_pt, xy, w = observation_table_compact(st, kp.xy, pp, n_points=B)
    g = torch.Generator(device="cuda").manual_seed(1)
    fix = torch.zeros(st.n_views, dtype=torch.bool, device="cuda")
    fix[int(res10.metrics["baseline_pair_i"])] = True
    prob = BAProblem(
        cameras=st.cameras, focal=st.focal,
        points=st.points_xyz[:B] + 0.01 * torch.randn((B, 3), generator=g, device="cuda"),
        obs_cam=obs_cam, obs_pt=obs_pt, obs_xy=xy, obs_w=w, fix_cam=fix,
        fix_focal=torch.tensor(not cfg.ba.optimize_focal, device="cuda"),
    )
    iters = 10

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    one, t_one = timed(lambda: run_ba(prob, cfg.ba, max_iterations=iters))
    four, t_four = timed(lambda: run_ba_sharded(prob, cfg.ba, shards, max_iterations=iters))
    cam_err = float(torch.max(torch.abs(four.cameras - one.cameras)))
    cost_rel = abs(float(four.final_cost) - float(one.final_cost)) / max(float(one.final_cost), 1e-12)
    print(
        "sharding: run_ba_sharded over [cuda:0] x 4 on the V=10 final problem (%d observations, "
        "%d points, points shaken by 0.01): %d iterations (one device %d), cost %.3f -> %.3f "
        "(one device %.3f), final cost rel diff %.2e (rtol 1e-3), max |camera diff| %.2e "
        "(atol 5e-4); %.3f s (one device %.3f s)"
        % (
            prob.n_obs, B, four.iterations, one.iterations, float(four.initial_cost),
            float(four.final_cost), float(one.final_cost), cost_rel, cam_err, t_four, t_one,
        )
    )
    _require(four.iterations == one.iterations, "sharded BA: another iteration count")
    _require(cost_rel <= 1e-3, f"sharded BA: final cost {cost_rel} apart (rtol 1e-3)")
    _require(cam_err <= 5e-4, f"sharded BA: cameras {cam_err} apart (atol 5e-4)")
    _require(float(four.final_cost) < float(four.initial_cost), "sharded BA did not descend")
    return launches


def _write_scene(scene, directory):
    """The scene as the command line reads it: PNG images and an OpenCV
    calibration XML. Returns (image directory, calibration path)."""
    from PIL import Image

    img_dir = os.path.join(directory, "images")
    os.makedirs(img_dir)
    for i, im in enumerate(scene.images.color):
        Image.fromarray(np.clip(np.round(im * 255), 0, 255).astype(np.uint8)).save(
            os.path.join(img_dir, f"view_{i:03d}.png")
        )
    K = scene.intrinsics.K
    xml = os.path.join(directory, "calib.xml")
    with open(xml, "w") as f:
        f.write(
            '<?xml version="1.0"?>\n<opencv_storage>\n'
            '<Camera_Matrix type_id="opencv-matrix"><rows>3</rows><cols>3</cols><dt>d</dt>\n'
            f"<data>{' '.join(repr(float(v)) for v in K.reshape(-1))}</data></Camera_Matrix>\n"
            '<Distortion_Coefficients type_id="opencv-matrix"><rows>1</rows><cols>5</cols>'
            "<dt>d</dt>\n<data>0. 0. 0. 0. 0.</data></Distortion_Coefficients>\n"
            "</opencv_storage>\n"
        )
    return img_dir, xml


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_two_ranks(workdir, t_single):
    """Phase 12: the command line's multi-process mode, two ranks on the one
    card. Returns the ranks' knn2 launches."""
    import re

    scene = courtyard(MH_VIEWS, MH_RING)
    img_dir, xml = _write_scene(scene, os.path.join(workdir, "mh_scene"))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    procs, outs = [], []
    for r in range(2):
        cmd = [
            sys.executable, "-m", "sfm_danpipeline_torch.cli", "--images", img_dir,
            "--calibration", xml, "--output", os.path.join(workdir, f"mh_out{r}"),
            "--stages", "sfm", "--coordinator", f"localhost:{port}", "--num-processes", "2",
            "--process-id", str(r), "--sharded-min-obs", str(MH_SHARDED_MIN_OBS),
        ]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env))
    t0 = time.time()
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, MH_TIMEOUT_S - (time.time() - t0)))[0].decode())
    finally:
        for p in procs:  # a failed or late rank must not outlive the script
            if p.poll() is None:
                p.kill()
                p.wait()
    digests, launches, recs = [], 0, []
    for r, (p, out) in enumerate(zip(procs, outs)):
        _require(p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-3000:]}")
        line = [ln for ln in out.splitlines() if f"rank {r}: registered" in ln]
        _require(len(line) == 1, f"rank {r} printed no digest:\n{out[-3000:]}")
        m = re.search(
            r"registered (\[.*\]) camera sum (\S+) points (\d+) backend (\S+) knn2 launches (\d+)",
            line[0],
        )
        digests.append(m.group(1, 2, 3))
        launches += int(m.group(5))
        with open(os.path.join(workdir, f"mh_out{r}", "metrics.jsonl")) as f:
            rec = {x["stage"]: x for x in map(json.loads, f)}
        recs.append(rec)
        print(f"two ranks: {line[0].split('cli: ', 1)[-1]}; t_sfm {rec['timing']['t_sfm']:.3f} s")
    m0 = recs[0]["sfm"]
    with open(os.path.join(workdir, "mh_out0", "cameras.json")) as f:
        cams = json.load(f)
    ate_frac = ate_fraction(scene, cams["cameras"], cams["registered_views"])
    print(
        "two ranks: backend %s, %d/%d registered, RMS %.3f px, ATE %.4f%% of diameter, %d points, "
        "polish cost %.4f -> %.4f over %d processes; t_sfm %s s against %.3f s for one process "
        "(phase 4's t_total, in memory)"
        % (
            m0["dist_backend"], m0["n_registered"], MH_VIEWS, m0["ba_rms_px"], 100 * ate_frac,
            m0["n_points"], m0["mh_polish_cost0"], m0["mh_polish_cost1"], m0["n_processes"],
            " / ".join("%.3f" % rec["timing"]["t_sfm"] for rec in recs), t_single,
        )
    )
    _require(digests[0] == digests[1], f"the ranks' reconstructions differ: {digests}")
    _require(all(rec["sfm"].get("dist_backend") for rec in recs), "no dist_backend recorded")
    _require(m0["n_registered"] == MH_VIEWS, f"two ranks: registered {m0['n_registered']}/{MH_VIEWS}")
    _require(m0["ba_rms_px"] < 1.0, f"two ranks: BA RMS {m0['ba_rms_px']} px >= 1")
    _require(ate_frac < 0.01, f"two ranks: ATE {ate_frac} of diameter >= 1%")
    _require(
        m0["mh_polish_cost1"] <= m0["mh_polish_cost0"],
        f"two ranks: the polish raised the cost ({m0['mh_polish_cost0']} -> {m0['mh_polish_cost1']})",
    )
    _require(launches == 2, f"the ranks launched knn2 {launches} times, not once each")
    return {"knn2": launches}


def run_guided():
    """Phase 13: SfMPipeline on the V=20 arc with guided bridging on."""
    from sfm_danpipeline_torch.config import PipelineConfig
    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline

    scene = courtyard(20, 0.4)
    cfg = PipelineConfig()
    cfg = dataclasses.replace(cfg, geometry=dataclasses.replace(cfg.geometry, guided_enable=True))
    # The guided bridge's diagnostics at view 11, where the two basins part.
    diag = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda rec: diag.append(rec.getMessage())
    logger = logging.getLogger("sfm_danpipeline_torch")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        res, launches = _count_launches(
            lambda: SfMPipeline(cfg, device="cuda").run(scene.images, scene.intrinsics)
        )
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    view11 = [d for d in diag if d.startswith("view 11 guided diag")]
    m = res.metrics
    ate_frac = ate_fraction(scene, res.state.cameras.cpu().numpy(), res.registered_views)
    stages = {k: round(v, 3) for k, v in m.items() if k.startswith("t_")}
    print(f"guided V=20 stages (s): {json.dumps(stages)}")
    _print_departures("guided V=20", res)
    print(
        "guided V=20: registered %d/20 %s, %d by the guided bridge, block realign %s, "
        "components %d (merged %d), RMS %.3f px, %d points, ATE %.4f%% of diameter, knn2 "
        "launches %d; reference (JAX, CPU): registered %d, %d guided, block realign %s, RMS "
        "%.3f px, %d points, ATE %.2f%%"
        % (
            m["n_registered"], res.registered_views, m["n_guided_registered"],
            "applied %d" % m["block_realign_applied"] if "block_realign_applied" in m
            else "not applied", m["n_components"], m["n_merged_components"], m["ba_rms_px"],
            m["n_points"], 100 * ate_frac, launches["knn2"], REF_GUIDED["n_registered"],
            REF_GUIDED["n_guided_registered"], REF_GUIDED["block_realign_applied"],
            REF_GUIDED["ba_rms_px"], REF_GUIDED["n_points"], REF_GUIDED["ate_pct"],
        )
    )
    print(
        "guided V=20 at view 11: port %s; reference (JAX, CPU, seed 0): the basin with %d "
        "anchored matches" % ("; ".join(view11) or "no guided attempt", REF_GUIDED["view11_basin_matches"])
    )
    _require(
        m["n_registered"] >= REF_GUIDED["n_registered"],
        f"guided: registered {m['n_registered']}, the reference {REF_GUIDED['n_registered']}",
    )
    _require(m["n_guided_registered"] >= 1, "guided: no view registered by the guided bridge")
    _require(m["ba_rms_px"] < 1.0, f"guided: BA RMS {m['ba_rms_px']} px >= 1")
    _require(launches["knn2"] == 1, f"guided: knn2 launched {launches['knn2']} times, not once")
    return launches


def run_ring(logdir):
    """Phase 16: SfMPipeline.run on the 50-view ring at each seed of
    RING_SEEDS, beside the reference's numbers, held to the gates the
    reference meets at that seed; every seed runs before the gates are
    read. Saves the seed-0 run's keypoints under `logdir` for the kernel
    check."""
    from sfm_danpipeline_torch.config import PipelineConfig
    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline

    scene = courtyard(RING_VIEWS, 1.0)
    base = PipelineConfig()
    launches, failed = {"knn2": 0}, []
    # The pipeline's decisions: the merges and the reinit are printed, the
    # few hundred PnP failures of a ring run only counted.
    trail = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda rec: trail.append(rec.getMessage())
    logger = logging.getLogger("sfm_danpipeline_torch")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    for seed in RING_SEEDS:
        cfg = dataclasses.replace(base, geometry=dataclasses.replace(base.geometry, seed=seed))
        pipe = SfMPipeline(cfg, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        trail.clear()
        with _BaselineSplit() as timer:
            res, la = _count_launches(lambda: pipe.run(scene.images, scene.intrinsics))
        launches["knn2"] += la["knn2"]
        if seed == RING_SEEDS[0]:
            kp = res.keypoints
            torch.save(
                {f: getattr(kp, f).cpu() for f in ("descriptors", "valid", "xy")},
                os.path.join(logdir, RING_KEYPOINTS),
            )
        m, regs, ref = res.metrics, res.registered_views, REF_RING[seed]
        ate = 100 * ate_fraction(scene, res.state.cameras.cpu().numpy(), regs)
        tag = f"ring V={RING_VIEWS} seed {seed}"
        decisions = [t for t in trail if t.startswith(RING_DECISIONS)]
        n_failed = sum("PnP failed" in t for t in trail)
        _print_departures(tag, res)
        print(f"{tag} decisions ({n_failed} PnP failures not shown):")
        print("".join(f"  {t}\n" for t in decisions), end="")
        stages = {k: round(v, 3) for k, v in m.items() if k.startswith("t_")}
        print(f"{tag} stages (s): {json.dumps(stages)}")
        split = timer.split(m["t_baseline"])
        print(
            "%s t_baseline %.3f s: pair scoring %.3f s, prefilter %.3f s, seed bootstrap "
            "(_try_seed) %.3f s, rest %.3f s (%d pairs); peak card memory %.2f GiB"
            % (tag, m["t_baseline"], split["scoring"], split["prefilter"], split["seed"],
               split["rest"], m["n_pairs"], torch.cuda.max_memory_allocated() / 2**30)
        )
        print(
            "%s: port (card) %d/%d registered %s, RMS %.4f px, %d points, ATE %.4f%%, "
            "rotavg_applied %s, %d registration keys, knn2 launches %d; reference (JAX, CPU) %d/%d "
            "registered %s, RMS %.4f px, %d points, ATE %.4f%%, rotavg_applied %s, %d keys"
            % (
                tag, len(regs), RING_VIEWS, regs, m["ba_rms_px"], m["n_points"], ate,
                m.get("rotavg_applied"), pipe._progress.key_n, la["knn2"], len(ref["registered"]), RING_VIEWS,
                ref["registered"], ref["ba_rms_px"], ref["n_points"], ref["ate_pct"],
                ref["rotavg_applied"], ref["key_n"],
            )
        )
        if seed in RING_ROUNDING_SEEDS:
            core = len(set(regs) & set(RING_CORE))
            count = (core >= RING_CORE_MIN, f"registered {core} of the core views "
                     f"{RING_CORE.start}-{RING_CORE.stop - 1}, fewer than {RING_CORE_MIN}")
        else:
            count = (len(regs) == len(ref["registered"]),
                     f"registered {len(regs)}, the reference {len(ref['registered'])}")
        gates = [
            count,
            (la["knn2"] == 1, f"knn2 launched {la['knn2']} times, not once"),
            (np.isfinite(res.points).all() and len(res.points) > 0, "bad sparse cloud"),
        ]
        if ref["ba_rms_px"] < 1.0:
            gates.append((m["ba_rms_px"] < 1.0, f"BA RMS {m['ba_rms_px']} px >= 1"))
        if seed in RING_ROUNDING_SEEDS:
            print(
                f"{tag}: parts from the reference by float rounding ({RING_ROUNDING_SEEDS[seed]}; "
                f"ROADMAP Queue 3, V=50 ring): held to RMS and to at least {RING_CORE_MIN} of the "
                f"core views {RING_CORE.start}-{RING_CORE.stop - 1} only ({core} registered)"
            )
        else:
            gates.append((
                abs(m["n_points"] - ref["n_points"]) <= RING_POINTS_RTOL * ref["n_points"],
                f"{m['n_points']} points, not within {RING_POINTS_RTOL:.0%} of {ref['n_points']}",
            ))
            if ref["ate_pct"] < 1.0:
                gates.append((ate < 1.0, f"ATE {ate:.4f}% >= 1%"))
        failed += [f"{tag}: {msg}" for ok, msg in gates if not ok]
    logger.removeHandler(handler)
    _require(not failed, "; ".join(failed))
    return launches


def check_knn2_ring(logdir):
    """Phase 16's kernel check: knn2 at the ring's shape on the seed-0
    run's own descriptors, every pair, indices held equal on every row the
    matcher keeps and elsewhere to near-ties; timed."""
    from sfm_danpipeline_torch.utils.knn_cases import KnnCase

    kp = torch.load(os.path.join(logdir, RING_KEYPOINTS))
    pi, pj = np.triu_indices(RING_VIEWS, 1)
    case = KnnCase(
        kp["descriptors"].numpy(), kp["valid"].numpy(), kp["xy"].numpy(),
        pi.astype(np.int32), pj.astype(np.int32), _cli_config("sift").matching.dup_radius**2,
    )
    m = _cli_config("sift").matching
    return check_knn2_case(
        f"ring V={RING_VIEWS} run's descriptors", case, timed=True,
        kept_ratio=max(m.ratio, m.registration_ratio),
    )


def _phase_child(name, logdir):
    """Entry of a child process: run one phase, then print its launch counts
    on a marked line for the parent."""
    phases = {"guided": run_guided, "flow": run_flow_seeds, "ring": lambda: run_ring(logdir)}
    launches = phases[name]()
    print(CHILD_MARK + json.dumps(launches), flush=True)


def _start_phase(name, logdir):
    """Start phase `name` (a key of CHILD_TIMEOUT_S) in a child process whose
    output goes to a file under `logdir`."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = open(os.path.join(logdir, f"{name}.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke._phase_child({name!r}, {logdir!r})"],
        stdout=out, stderr=subprocess.STDOUT, cwd=here,
        env=dict(os.environ, PYTHONPATH=here),
    )
    return name, proc, out, time.time()


def _stop(child):
    _, proc, out, _ = child
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    out.close()


def _join_phase(child):
    """Wait for a child phase within its time, print its output, and return
    its launch counts; fails if it failed, printed no counts or ran late."""
    name, proc, out, t0 = child
    try:
        proc.wait(timeout=max(1.0, CHILD_TIMEOUT_S[name] - (time.time() - t0)))
    except subprocess.TimeoutExpired:
        pass
    late = proc.poll() is None
    _stop(child)
    with open(out.name) as f:
        lines = f.read().splitlines()
    launches = None
    for line in lines:
        if line.startswith(CHILD_MARK):
            launches = json.loads(line[len(CHILD_MARK):])
        else:
            print(line)
    print(f"phase {name} (own process): {time.time() - t0:.0f}s")
    _require(not late, f"phase {name} ran past {CHILD_TIMEOUT_S[name]}s")
    _require(proc.returncode == 0 and launches is not None, f"phase {name} exited {proc.returncode}")
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
    # Phase 13 runs beside phases 4-7, and the flow runs of phase 10 and
    # phase 16 beside phase 12, each in a process of its own; no kernel is
    # timed while a child runs.
    children = []
    with tempfile.TemporaryDirectory() as logdir:
        try:
            children.append(_start_phase("guided", logdir))
            scene10, res10, l4 = run_pipeline(10, 0.2, components=1)
            scene20, res20, l5 = run_pipeline(20, 0.4, components=2)
            l6 = run_dense(scene20, res20)
            del scene20, res20
            check_repeatability(scene10, res10)
            check_draws(*check_pair_batch(scene10, res10))
            l13 = _join_phase(children[-1])
            with tempfile.TemporaryDirectory() as workdir:
                run8, l8, paths, row512 = run_cli_akaze(scene10, workdir)
                l9 = run_resume(scene10, workdir, run8, paths)
            res_orb, cfg_orb, l10a, _ = run_frontend(
                "ORB V=10", "orb", "bf", 0.2, REF_ORB, knn2_launches=1
            )
            row256 = check_knn2_on_run("ORB run's descriptors", res_orb, cfg_orb)
            l11 = check_sharding(scene10, res10, _cli_config("sift"))
            children.append(_start_phase("flow", logdir))
            ring = _start_phase("ring", logdir)
            children.append(ring)
            with tempfile.TemporaryDirectory() as workdir:
                l12 = run_two_ranks(workdir, res10.metrics["t_total"])
            l10b = _join_phase(children[-2])
            l16 = _join_phase(ring)
            row_ring = check_knn2_ring(logdir)
        finally:
            for child in children:  # a failed phase must not leave a child running
                _stop(child)
    for part in (l4, l5, l6, l8, l9, l10a, l10b, l11, l12, l13, l16):
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
        # The 50-view ring's matching call (phase 16), P = 1,225 at D = 128.
        "ring_shape": {"pairs": RING_VIEWS * (RING_VIEWS - 1) // 2, "d": D, **row_ring},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
