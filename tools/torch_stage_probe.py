#!/usr/bin/env python3
"""One-off measurements of the PyTorch port on a CUDA card that the smoke
run (chip_smoke.py) does not make. Each prints the card's name and power
limit first.

    python3 tools/torch_stage_probe.py time-stages [--root DIR]

times SIFT on the V=10 courtyard images and a 10-iteration BA step from the
V=10 result (medians of 5, synchronized). It uses only what the port has had
since its first slice, so `--root` may name an older checkout of the
repository: run old, new, new, old in one call to compare two commits on one
card.

    python3 tools/torch_stage_probe.py time-baseline [--root DIR] [--scenes v10 v20] [--repeats 3]
        [--baseline-seeds 0]

runs SfMPipeline on each scene (v10: the V=10 control, ring_fraction 0.2;
v20: the V=20 arc, 0.4; ring50: the 50-view ring, ring_fraction 1.0, as
tools/bench_scale.py builds it) at each `geometry.seed` of
`--baseline-seeds`, `--repeats` times, and prints, per scene and seed, the
median of each part of t_baseline: pair scoring, the all-pairs
prefilter, the seed bootstrap (`_try_seed`) and the rest, each timed by
wrapping the function with synchronized wall clocks, beside t_baseline,
t_total, the registered views, RMS, ATE and the card's peak memory. The
wrapped names exist in every commit of the port, so `--root` may name an
older checkout: run old, new, new, old in one call.

    python3 tools/torch_stage_probe.py profile [--scenes v10 v20]

runs SfMPipeline once per scene under torch.profiler (host and device
activity) after one unprofiled warm-up run, and prints the run's wall time,
the device's busy time (the union of its kernel and copy intervals), the
idle share (1 - busy / wall) and the top device rows: kernels and copies by
name, with their summed time and count.

    python3 tools/torch_stage_probe.py cli-akaze --out DIR

runs the command line's stage runner with --detector akaze and every stage
on the V=10 courtyard (the run chip_smoke.py phase 8 makes) and leaves its
artifacts (dense.ply, filtered.ply, metrics.jsonl, ...) in DIR, for
tools/reference_dense_analysis.py to read.

    python3 tools/torch_stage_probe.py pair-batch-audit

finds where a pair's two-view estimate depends on the batch around it: on
the V=10 courtyard's strict matches, each stage of the pose search (the
8-point fits, the Sampson table, the top 8, the cheirality pick, the
polish) for every pair at once against the same pair alone, and the
batched library calls under it (eigh, svd, bmm, solve_ex) on a batch
against the same matrices one slice at a time, printing the largest
difference of each.

    python3 tools/torch_stage_probe.py determinism-audit

runs the four V=10 paths (SIFT, every command-line stage with AKAZE, ORB, LK
flow) under torch.use_deterministic_algorithms(True, warn_only=True) and
prints every operation PyTorch warns about. A run may end differently under
that setting (cuBLAS takes another workspace, so last bits differ); the audit
reports it, goes on, and exits 1 if any run stopped.

    python3 tools/torch_stage_probe.py eigh-audit

compares the 8-point fits' null vectors (the smallest eigenvector of each
hypothesis' A^T A) from the card's and the CPU's float32 eigh with a
float64 eigh of the same matrices, on the pipeline's seed-0 scoring draws
of the V=10 control and the narrow flow arc.

    python3 tools/torch_stage_probe.py flow-frontend [--seeds 0 1 2 ...]

compares the flow arc's front end (SIFT keypoints, flow match sets and
their slot order) on the card with the CPU's, then runs the pipeline at
each seed on the CPU's front end with the back end on the card and on the
CPU.

    python3 tools/torch_stage_probe.py flow-seeds [--seeds 0 1 2 ...] [--device cpu] [--root DIR]

runs SfMPipeline with the LK-flow matcher on the narrow V=10 arc
(ring_fraction 0.05) once per RANSAC seed and prints registered views, the
seed pair, RMS, points and the trajectory error of each, then the median.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(ring_fraction):
    from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene

    return make_courtyard_scene(n_views=10, ring_fraction=ring_fraction, seed=0)


def _ate_pct(scene, res):
    from sfm_danpipeline_torch.utils.metrics import aligned_rmse, camera_centers

    regs = sorted(res.registered_views)
    c = camera_centers(res.state.cameras.cpu().numpy())[regs]
    g = scene.centers[regs]
    return 100 * aligned_rmse(c, g) / float(np.linalg.norm(g.max(0) - g.min(0)))


def _config(detector="sift", matcher="bf"):
    """The config the command line builds for --detector / --matcher."""
    from sfm_danpipeline_torch import cli

    return cli.config_from_args(cli.build_parser().parse_args(
        ["--images", "-", "--calibration", "-", "--detector", detector, "--matcher", matcher]
    ))


def _wall_ms(fn, n=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def time_stages():
    from sfm_danpipeline_torch.config import PipelineConfig
    from sfm_danpipeline_torch.ops.sift import detect_and_compute_batch
    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline, ba_step

    cfg = PipelineConfig()
    scene = _scene(0.2)
    res = SfMPipeline(cfg, device="cuda").run(scene.images, scene.intrinsics)
    gray = torch.as_tensor(scene.images.gray, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    st = res.state
    noise = 0.01 * torch.randn(st.points_xyz.shape, generator=g, device="cuda")
    st = dataclasses.replace(st, points_xyz=st.points_xyz + noise)
    pp = torch.tensor([scene.intrinsics.cx, scene.intrinsics.cy], device="cuda")
    fix = torch.zeros(st.n_views, dtype=torch.bool, device="cuda")
    fix[int(res.metrics["baseline_pair_i"])] = True

    sift_ms = _wall_ms(lambda: detect_and_compute_batch(gray, cfg.features))
    ba_ms = _wall_ms(lambda: ba_step(st, res.keypoints.xy, pp, fix, cfg, 10))
    its = ba_step(st, res.keypoints.xy, pp, fix, cfg, 10)[3]
    print(json.dumps({
        "time_stages": {
            "sift_v10_ms": sift_ms, "ba_step_ms": ba_ms, "ba_iterations": int(its),
            "pipeline_t_features_s": res.metrics["t_features"],
            "pipeline_t_final_ba_s": res.metrics["t_final_ba"],
            "pipeline_t_total_s": res.metrics["t_total"],
        }
    }))
    return 0


BASELINE_SCENES = {"v10": (10, 0.2), "v20": (20, 0.4), "ring50": (50, 1.0)}


def _timed_parts():
    """Wrap pair scoring, the prefilter and the seed bootstrap of the
    pipeline module with synchronized wall clocks; returns (times, undo).
    `_try_seed` also seeds later components: its first call is the one
    inside t_baseline."""
    from sfm_danpipeline_torch.pipeline import sfm

    times = {"scoring": [], "prefilter": [], "seed": []}
    saved = []

    def wrap(owner, attr, key):
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t0)
            return out

        setattr(owner, attr, timed)

    wrap(sfm, "score_pairs", "scoring")
    wrap(sfm, "epipolar_prefilter_table", "prefilter")
    wrap(sfm.SfMPipeline, "_try_seed", "seed")

    def undo():
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)

    return times, undo


def time_baseline(scenes, repeats, seeds=(0,)):
    from sfm_danpipeline_torch.config import PipelineConfig
    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline
    from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene

    import sfm_danpipeline_torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(sfm_danpipeline_torch.__file__)))
    for name, seed in ((n, s) for n in scenes for s in seeds):
        n_views, ring = BASELINE_SCENES[name]
        scene = make_courtyard_scene(n_views=n_views, ring_fraction=ring, seed=0)
        cfg = PipelineConfig()
        cfg = dataclasses.replace(cfg, geometry=dataclasses.replace(cfg.geometry, seed=seed))
        runs = []
        for _ in range(repeats):
            torch.cuda.reset_peak_memory_stats()
            times, undo = _timed_parts()
            try:
                res = SfMPipeline(cfg, device="cuda").run(scene.images, scene.intrinsics)
            finally:
                undo()
            m = res.metrics
            parts = {k: v[0] if v else 0.0 for k, v in times.items()}
            parts["rest"] = m["t_baseline"] - sum(parts.values())
            runs.append(dict(
                parts, t_baseline=m["t_baseline"], t_total=m["t_total"],
                n_registered=m["n_registered"], ba_rms_px=m["ba_rms_px"],
                n_points=m["n_points"], ate_pct=_ate_pct(scene, res),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            ))
            del res
        print(json.dumps({"time_baseline": {
            "root": root, "scene": name, "seed": seed, "n_views": n_views, "n_pairs": n_views * (n_views - 1) // 2,
            "median": {k: float(np.median([r[k] for r in runs])) for k in runs[0]},
            "runs": runs,
        }}), flush=True)
    return 0


def _merged_length(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def profile_runs(scenes, top=15):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sfm_danpipeline_torch.config import PipelineConfig
    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline
    from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene

    for name in scenes:
        n_views, ring = BASELINE_SCENES[name]
        scene = make_courtyard_scene(n_views=n_views, ring_fraction=ring, seed=0)
        pipe = SfMPipeline(PipelineConfig(), device="cuda")
        pipe.run(scene.images, scene.intrinsics)  # warm-up: allocator, cuBLAS / cuSOLVER handles
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = pipe.run(scene.images, scene.intrinsics)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = _merged_length((e.time_range.start, e.time_range.end) for e in dev) / 1e6

        by_name = {}
        for e in dev:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.end - e.time_range.start, n + 1)
        rows = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
        print(json.dumps({"profile": {
            "scene": name, "n_views": n_views, "wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall, "device_events": len(dev),
            "t_baseline_s": res.metrics["t_baseline"], "t_total_s": res.metrics["t_total"],
            "top_device_rows": [
                {"name": name[:90], "device_ms": us / 1e3, "launches": n} for name, (us, n) in rows[:top]
            ],
        }}), flush=True)
    return 0


def cli_akaze(out):
    from sfm_danpipeline_torch import cli

    scene = _scene(0.2)
    run = cli.run_stages(scene.images, scene.intrinsics, _config("akaze"), out, list(cli.STAGES), device="cuda")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        for line in f:
            if json.loads(line).get("stage") in ("dense", "filter", "dendrometry"):
                print(line.strip()[:400])
    return run.code


def _max_diff(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def pair_batch_audit(device="cuda"):
    from sfm_danpipeline_torch.config import PipelineConfig
    from sfm_danpipeline_torch.ops import epipolar as E
    from sfm_danpipeline_torch.ops import prng
    from sfm_danpipeline_torch.ops.matching import match_all_pairs
    from sfm_danpipeline_torch.ops.projection import undistort_points
    from sfm_danpipeline_torch.ops.ransac import gather_rows, sample_indices
    from sfm_danpipeline_torch.ops.sift import detect_and_compute_batch

    cfg = PipelineConfig()
    scene = _scene(0.2)
    kp = detect_and_compute_batch(torch.as_tensor(scene.images.gray, device=device), cfg.features)
    V = kp.valid.shape[0]
    pi, pj = (torch.as_tensor(a, dtype=torch.int32, device=device) for a in np.triu_indices(V, 1))
    m = match_all_pairs(
        kp.descriptors, kp.valid, pi, pj, ratio=cfg.matching.ratio, max_matches=cfg.matching.max_matches,
        xy=kp.xy, dup_radius=cfg.matching.dup_radius, dedup=cfg.matching.dedup_matches,
    )
    K = torch.as_tensor(scene.intrinsics.K, dtype=torch.float32, device=device)
    dist = torch.zeros(5, device=device)
    x1 = undistort_points(kp.xy[pi.long()[:, None], m.idx_a.long()], K, dist)
    x2 = undistort_points(kp.xy[pj.long()[:, None], m.idx_b.long()], K, dist)
    valid = m.valid
    idx = sample_indices(prng.split(prng.key(0, device=device), len(pi)), valid, 512, 8)
    rn2 = (2.5 / float(K[0, 0])) ** 2
    out = {}

    def record(name, a, b):
        out[name] = max(out.get(name, 0.0), _max_diff(a, b))

    # Library calls on a batch against the same matrices in slices of 512.
    A = torch.randn(len(pi) * 512, 9, 9, device=device)
    A = A @ A.transpose(-1, -2)
    B3 = torch.randn(len(pi) * 512, 3, 3, device=device)
    H6 = torch.randn(len(pi), 6, 6, device=device)
    H6 = H6 @ H6.transpose(-1, -2) + torch.eye(6, device=device)
    g6 = torch.randn(len(pi), 6, device=device)
    for name, fn, X in (
        ("eigh 9x9 vectors", lambda a: torch.linalg.eigh(a)[1], A[:8192]),
        ("svd 3x3 U", lambda a: torch.linalg.svd(a)[0], B3[:8192]),
        ("bmm 3x3", lambda a: a @ a, B3[:8192]),
    ):
        whole = fn(X)
        record(name + " (slices of 512)", whole, torch.cat([fn(c) for c in X.split(512)]))
        record(name + " (one at a time, first 64)", whole[:64], torch.cat([fn(c) for c in X[:64].split(1)]))
    solve = lambda h, g: torch.linalg.solve_ex(h, g)[0]  # noqa: E731
    record("solve_ex 6x6 (one at a time)", solve(H6, g6), torch.cat([solve(h[None], v[None]) for h, v in zip(H6, g6)]))

    # The pose search, stage by stage: every pair at once against each alone.
    from sfm_danpipeline_torch.ops import homography as Hm
    from sfm_danpipeline_torch.ops.triangulation import pose_matrix, triangulate_dlt

    px1 = kp.xy[pi.long()[:, None], m.idx_a.long()]
    px2 = kp.xy[pj.long()[:, None], m.idx_b.long()]
    idx4 = idx[..., :4]
    h_all = Hm._homography_from_four(gather_rows(px1, idx4), gather_rows(px2, idx4))
    tri_P2 = pose_matrix(torch.eye(3, device=device), torch.tensor([1.0, 0.0, 0.0], device=device))
    tri_P1 = pose_matrix(torch.eye(3, device=device), torch.zeros(3, device=device))
    tri_all = triangulate_dlt(tri_P1, tri_P2, x1, x2)
    models = E._fit_essential_dlt(gather_rows(x1, idx), gather_rows(x2, idx), torch.ones(idx.shape, device=device))
    s_all = E._pose_search(x1, x2, valid, rn2, idx)
    for p in range(len(pi)):
        sl = slice(p, p + 1)
        mp = E._fit_essential_dlt(gather_rows(x1[sl], idx[sl]), gather_rows(x2[sl], idx[sl]), torch.ones(idx[sl].shape, device=device))
        record("8-point fits", models[sl], mp)
        record("4-point homographies", h_all[sl], Hm._homography_from_four(gather_rows(px1[sl], idx4[sl]), gather_rows(px2[sl], idx4[sl])))
        record("triangulate_dlt", tri_all[sl], triangulate_dlt(tri_P1, tri_P2, x1[sl], x2[sl]))
        s1 = E._pose_search(x1[sl], x2[sl], valid[sl], rn2, idx[sl])
        for k in ("scores", "R0", "t0", "R", "t"):
            record(f"pose search {k}", s_all[k][sl], s1[k])
        for k in ("band0", "band"):
            out[f"pose search {k} entries differing"] = out.get(f"pose search {k} entries differing", 0) + int(
                (s_all[k][sl] != s1[k]).sum()
            )
        out["pose search top-8 differing pairs"] = out.get("pose search top-8 differing pairs", 0) + int(
            not torch.equal(
                torch.sort(-s_all["scores"][sl], stable=True).indices[..., :8],
                torch.sort(-s1["scores"], stable=True).indices[..., :8],
            )
        )
    print(json.dumps({"pair_batch_audit": {"device": str(device), "pairs": len(pi), **out}}, indent=1))
    return 0


def determinism_audit():
    from sfm_danpipeline_torch import cli
    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline

    # cuBLAS is only deterministic with a fixed workspace; PyTorch asks for
    # this setting before the library's first use.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    seen, stopped = {}, []
    with warnings.catch_warnings(record=True) as caught, tempfile.TemporaryDirectory() as tmp:
        warnings.simplefilter("always")
        scene, narrow = _scene(0.2), _scene(0.05)
        runs = {
            "sift": lambda: SfMPipeline(_config("sift"), device="cuda").run(
                scene.images, scene.intrinsics
            ),
            "akaze, every CLI stage": lambda: cli.run_stages(
                scene.images, scene.intrinsics, _config("akaze"), os.path.join(tmp, "o"),
                list(cli.STAGES), device="cuda", checkpoint=os.path.join(tmp, "s.npz"),
            ),
            "orb": lambda: SfMPipeline(_config("orb"), device="cuda").run(
                scene.images, scene.intrinsics
            ),
            "flow": lambda: SfMPipeline(_config("sift", "flow"), device="cuda").run(
                narrow.images, narrow.intrinsics
            ),
        }
        for name, fn in runs.items():
            try:
                fn()
                print(f"determinism audit: {name} ran to its end")
            except RuntimeError as e:
                stopped.append(name)
                print(f"determinism audit: {name} stopped: {e}")
    for w in caught:
        seen.setdefault(str(w.message).split("\n")[0], f"{w.filename}:{w.lineno}")
    print(f"determinism audit: {len(seen)} distinct warnings")
    for msg, where in seen.items():
        print(f"  {where}: {msg}")
    return 1 if stopped else 0


def _front_end(scene, cfg, device):
    """The port's SIFT keypoints and loose matches (kNN or flow, as `cfg`
    says) on `device` for every pair of `scene`."""
    from sfm_danpipeline_torch.ops.flow import flow_match_all_pairs
    from sfm_danpipeline_torch.ops.matching import match_all_pairs
    from sfm_danpipeline_torch.ops.sift import detect_and_compute_batch

    gray = torch.as_tensor(scene.images.gray, device=device)
    kp = detect_and_compute_batch(gray, cfg.features)
    V = kp.valid.shape[0]
    pi, pj = (torch.as_tensor(a, dtype=torch.int32, device=device) for a in np.triu_indices(V, 1))
    if cfg.matching.method == "flow":
        m = flow_match_all_pairs(
            gray, kp.xy, kp.valid, pi.tolist(), pj.tolist(), radius=cfg.matching.flow_radius,
            max_matches=cfg.matching.max_matches,
        )
    else:
        m = match_all_pairs(
            kp.descriptors, kp.valid, pi, pj,
            ratio=max(cfg.matching.ratio, cfg.matching.registration_ratio),
            max_matches=cfg.matching.max_matches, strict_ratio=cfg.matching.ratio, xy=kp.xy,
            dup_radius=cfg.matching.dup_radius, dedup=cfg.matching.dedup_matches,
        )
    return kp, m, pi.long(), pj.long()


def eigh_audit():
    """How far the 8-point fits' null vectors (the smallest eigenvector of
    each hypothesis' A^T A, as ops/epipolar.py builds it) lie from a float64
    eigh of the same matrices, for the card's and the CPU's float32 eigh, on
    the pipeline's seed-0 scoring draws of the V=10 control (SIFT) and the
    narrow flow arc."""
    from sfm_danpipeline_torch.ops import epipolar as E
    from sfm_danpipeline_torch.ops import prng
    from sfm_danpipeline_torch.ops.projection import undistort_points
    from sfm_danpipeline_torch.ops.ransac import gather_rows, linalg_in_slices, sample_indices
    from sfm_danpipeline_torch.ops.reduce import fixed_sum

    for name, ring, matcher in (("sift V=10", 0.2, "bf"), ("flow V=10", 0.05, "flow")):
        scene = _scene(ring)
        cfg = _config("sift", matcher)
        kp, m, pi, pj = _front_end(scene, cfg, "cuda")
        if matcher == "bf":
            m = m.at_ratio(cfg.matching.ratio)
        K = torch.as_tensor(scene.intrinsics.K, dtype=torch.float32, device="cuda")
        dist = torch.zeros(5, device="cuda")
        x1 = undistort_points(kp.xy[pi[:, None], m.idx_a.long()], K, dist)
        x2 = undistort_points(kp.xy[pj[:, None], m.idx_b.long()], K, dist)
        k_score = prng.split(prng.key(0, device="cuda"), 2)[0]
        k_e = prng.split(prng.split(k_score, len(pi)), 2)[:, 0]
        idx = sample_indices(k_e, m.valid, cfg.geometry.essential_ransac_iters, 8)
        s1, s2 = gather_rows(x1, idx), gather_rows(x2, idx)
        w = torch.ones(idx.shape, device="cuda")
        n1, _ = E._hartley_transform(s1, w)
        n2, _ = E._hartley_transform(s2, w)
        u1, v1, u2, v2 = n1[..., 0], n1[..., 1], n2[..., 0], n2[..., 1]
        A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], dim=-2)
        M = fixed_sum(A[..., :, None, :] * A[..., None, :, :]).reshape(-1, 9, 9)
        ok = m.valid.sum(-1)[:, None].expand(idx.shape[:2]).reshape(-1) >= 8
        M = M[ok]
        ref = torch.linalg.eigh(M.cpu().double())[1][..., 0]
        row = {}
        for dev in ("cuda", "cpu"):
            v = linalg_in_slices(torch.linalg.eigh, M.to(dev))[1][..., 0].cpu().double()
            err = 1.0 - torch.abs(torch.sum(v * ref, dim=-1))
            row[dev] = {
                "median": float(err.median()), "p90": float(err.quantile(0.9)),
                "max": float(err.max()), "frac_over_1e-3": float((err > 1e-3).double().mean()),
            }
        print(json.dumps({"eigh_audit": {"scene": name, "n_matrices": int(M.shape[0]), **row}}), flush=True)
    return 0


def flow_frontend(seeds):
    """The flow arc's front end on the card against the CPU's (keypoint
    counts and positions, each pair's match set and slot order), then the
    pipeline's back end at each seed on the CPU's front end, run on the card
    and on the CPU: where the two back ends part on the same inputs, and
    where the card's own front end takes the run elsewhere."""
    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline

    scene = _scene(0.05)
    cfg = _config("sift", "flow")
    t0 = time.perf_counter()
    fe = {dev: _front_end(scene, cfg, dev) for dev in ("cuda", "cpu")}
    print(f"flow front end on the card and on the CPU in {time.perf_counter() - t0:.1f}s", flush=True)
    kc, mc = fe["cuda"][0], fe["cuda"][1]
    kh, mh = fe["cpu"][0], fe["cpu"][1]
    same_kp = bool(torch.equal(kc.valid.cpu(), kh.valid))
    xy_gap = float((kc.xy.cpu() - kh.xy)[kh.valid].abs().max())
    same_sets = slots = total = 0
    for p in range(mh.valid.shape[0]):
        vc, vh = mc.valid[p].cpu(), mh.valid[p]
        ac, ah = mc.idx_a[p].cpu()[vc], mh.idx_a[p][vh]
        same_sets += int(set(ac.tolist()) == set(ah.tolist()))
        n = min(len(ac), len(ah))
        slots += int((ac[:n] == ah[:n]).sum())
        total += len(ah)
    print(
        "flow front end, card vs CPU: keypoint masks %s, largest xy gap %.3g px; match sets equal "
        "in %d of %d pairs; %d of %d valid slots hold the same match"
        % ("equal" if same_kp else "DIFFER", xy_gap, same_sets, mh.valid.shape[0], slots, total),
        flush=True,
    )
    scene_images = scene.images
    for seed in seeds:
        c = dataclasses.replace(cfg, geometry=dataclasses.replace(cfg.geometry, seed=seed))
        out = {}
        for dev in ("cuda", "cpu"):
            kp = type(kh)(*(getattr(kh, f.name).to(dev) for f in dataclasses.fields(kh)))
            m = type(mh)(*(getattr(mh, f.name).to(dev) for f in dataclasses.fields(mh)))
            try:
                res = SfMPipeline(c, device=dev).run(
                    scene_images, scene.intrinsics, precomputed_keypoints=kp, precomputed_matches=m
                )
            except RuntimeError:
                out[dev] = "no seed pair"
                continue
            mm = res.metrics
            out[dev] = "%d/10, pair (%d, %d), RMS %.4f px, ATE %.3f%%" % (
                mm["n_registered"], mm["baseline_pair_i"], mm["baseline_pair_j"], mm["ba_rms_px"],
                _ate_pct(scene, res),
            )
        print(f"flow seed {seed} on the CPU's front end: card back end {out['cuda']}; CPU back end {out['cpu']}", flush=True)
    return 0


def flow_seeds(seeds, device):
    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline

    scene = _scene(0.05)
    base = _config("sift", "flow")
    ates = []
    for seed in seeds:
        cfg = dataclasses.replace(base, geometry=dataclasses.replace(base.geometry, seed=seed))
        try:
            res = SfMPipeline(cfg, device=device).run(scene.images, scene.intrinsics)
        except RuntimeError as e:
            print(f"flow seed {seed}: failed: {e}")
            continue
        m = res.metrics
        ates.append(_ate_pct(scene, res))
        print(
            "flow seed %d: registered %d/10, seed pair (%d, %d), RMS %.4f px, %d points, "
            "ATE %.3f%% of diameter"
            % (
                seed, m["n_registered"], m["baseline_pair_i"], m["baseline_pair_j"],
                m["ba_rms_px"], m["n_points"], ates[-1],
            )
        )
    print(
        "flow seeds: %d of %d ran to their end, median ATE %s%%"
        % (len(ates), len(seeds), "%.3f" % np.median(ates) if ates else "n/a")
    )
    return 0 if len(ates) == len(seeds) else 1


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "mode",
        choices=[
            "time-stages", "time-baseline", "profile", "cli-akaze", "pair-batch-audit",
            "determinism-audit", "flow-seeds", "eigh-audit", "flow-frontend",
        ],
    )
    ap.add_argument("--out", default="out/akaze10", help="cli-akaze's output directory")
    ap.add_argument("--device", default="cuda", help="flow-seeds' device (cpu to compare commits on a CPU)")
    ap.add_argument("--root", default=HERE, help="checkout whose sfm_danpipeline_torch is run")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    ap.add_argument("--scenes", nargs="+", choices=list(BASELINE_SCENES), default=["v10", "v20"])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--baseline-seeds", type=int, nargs="+", default=[0], help="time-baseline's geometry.seed values")
    args = ap.parse_args()
    on_cpu = args.mode == "flow-seeds" and args.device == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        raise SystemExit("torch_stage_probe: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    print("cpu" if on_cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    if args.mode == "time-stages":
        return time_stages()
    if args.mode == "time-baseline":
        return time_baseline(args.scenes, args.repeats, args.baseline_seeds)
    if args.mode == "profile":
        return profile_runs(args.scenes)
    if args.mode == "cli-akaze":
        return cli_akaze(args.out)
    if args.mode == "pair-batch-audit":
        return pair_batch_audit()
    if args.mode == "determinism-audit":
        return determinism_audit()
    if args.mode == "eigh-audit":
        return eigh_audit()
    if args.mode == "flow-frontend":
        return flow_frontend(args.seeds)
    return flow_seeds(args.seeds, "cpu" if on_cpu else "cuda")


if __name__ == "__main__":
    sys.exit(main())
