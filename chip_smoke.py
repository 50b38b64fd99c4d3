#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (sfm_danpipeline_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and nvidia-smi; imports nothing of JAX. Phases,
each printed on its own line; any failure raises and exits non-zero:

  1. the card's name and power limit (nvidia-smi);
  2. build every hand-written kernel of the main path from csrc/;
  3. each kernel against its plain PyTorch version on the card, at the
     main-path shape, with both versions' median times;
  4. the port's SfMPipeline.run on the V=10 rendered courtyard at
     480x640 with the default PipelineConfig, held against ground truth,
     with the kernel launch counts of that run;
  5. SfMPipeline.run on the V=20 arc (480x640, default config), which
     splits into two components: the merge, the straggler sweep, the
     rotation-averaging reinit and local-window BA all run; held to the
     merge and quality gates and printed beside the reference's numbers;
  6. the dense stage (mvs.pipeline.densify) on the phase-5 result, held
     to the dense gates and to the reference's point count;

then the kernel summary line (launches summed over the pipeline runs of
phases 4-6), and as the last line the device record
{"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
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


def _knn2_inputs(device):
    """Unit descriptors with true matches, ~10% invalid rows, and ~10%
    co-located twins (same xy, near-duplicate descriptor) of B rows."""
    rng = np.random.default_rng(0)
    desc = rng.normal(size=(N_VIEWS, K, D)).astype(np.float32)
    xy = rng.uniform(0, 640, size=(N_VIEWS, K, 2)).astype(np.float32)
    for v in range(N_VIEWS):
        twins = rng.choice(K, K // 10, replace=False)
        src = rng.choice(K, K // 10, replace=False)
        desc[v, twins] = desc[v, src] + 0.2 * rng.normal(size=(K // 10, D))
        xy[v, twins] = xy[v, src]
        # Half of each view's rows are noisy copies of the next view's rows.
        half = rng.choice(K, K // 2, replace=False)
        desc[v, half] = desc[(v + 1) % N_VIEWS, half] + 0.3 * rng.normal(
            size=(K // 2, D)
        )
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    valid = rng.uniform(size=(N_VIEWS, K)) > 0.1
    pi, pj = np.triu_indices(N_VIEWS, 1)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    return (
        t(desc, torch.float32), t(valid, torch.bool), t(xy, torch.float32),
        t(pi, torch.int32), t(pj, torch.int32),
    )


def check_knn2():
    from sfm_danpipeline_torch.ops.matching import knn2, knn2_torch

    desc, valid, xy, pi, pj = _knn2_inputs("cuda")
    pil, pjl = pi.long(), pj.long()

    def plain():
        return knn2_torch(desc[pil], desc[pjl], valid[pjl], xy[pjl], DUP_R2)

    def kernel():
        return knn2(desc, valid, xy, pi, pj, DUP_R2)

    ik, bk, sk = kernel()
    torch.cuda.synchronize()  # a fault during the run surfaces here
    ip, bp, sp = plain()
    # Distances of both chosen columns, recomputed in float64.
    a64 = desc[pil].double()
    b64 = desc[pjl].double()

    def d2_at(idx):
        bsel = torch.gather(b64, 1, idx.long()[..., None].expand(-1, -1, D))
        d = ((a64 - bsel) ** 2).sum(-1)
        ok = torch.gather(valid[pjl], 1, idx.long())
        return torch.where(ok, d, torch.full_like(d, 3.4e38))

    mism = ik != ip
    dk, dp = d2_at(ik), d2_at(ip)
    tie = (dk - dp).abs() <= KNN2_TIE * torch.clamp(dp, min=1.0)
    n_mism = int(mism.sum())
    _require(
        not bool((mism & ~tie).any()),
        f"knn2: {int((mism & ~tie).sum())} index mismatches off a near-tie",
    )
    err_b = (bk - bp).abs()
    err_s = (sk - sp).abs()
    finite = sp < 3.4e38
    for name, err, ref, m in (
        ("best", err_b, bp, torch.ones_like(finite)),
        ("second", err_s, sp, finite),
    ):
        bad = m & (err > KNN2_ATOL + KNN2_RTOL * ref.abs())
        _require(
            not bool(bad.any()),
            f"knn2 {name} d2 disagrees at {int(bad.sum())} rows "
            f"(max err {float(err[m].max()):.3e})",
        )
    _require(
        torch.equal(sk >= 3.4e38, sp >= 3.4e38),
        "knn2: second-best sentinel rows differ",
    )
    max_err = float(torch.maximum(err_b.max(), err_s[finite].max()))
    ms_k = _median_ms(kernel)
    ms_p = _median_ms(plain)
    print(
        f"knn2: P={pi.numel()} Ka=Kb={K} D={D} dup_r2={DUP_R2}: "
        f"{n_mism} index mismatches (all near-ties), max |d2 err| "
        f"{max_err:.3e} (rtol {KNN2_RTOL}, atol {KNN2_ATOL}); median "
        f"kernel {ms_k:.3f} ms, knn2_torch {ms_p:.3f} ms"
    )
    return {"max_abs_err": max_err, "ms": ms_k, "plain_ms": ms_p}


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


def run_pipeline(n_views, ring_fraction, components):
    """Phases 4 and 5: SfMPipeline.run on the card, held against ground
    truth. Returns (scene, result, launches)."""
    from sfm_danpipeline_torch.config import PipelineConfig
    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline
    from sfm_danpipeline_torch.utils.metrics import aligned_rmse, camera_centers
    from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene

    t0 = time.time()
    scene = make_courtyard_scene(n_views=n_views, ring_fraction=ring_fraction, seed=0)
    print(f"scene: rendered {n_views} views 480x640 in {time.time() - t0:.1f}s")
    pipe = SfMPipeline(PipelineConfig(), device="cuda")
    res, launches = _count_launches(lambda: pipe.run(scene.images, scene.intrinsics))
    m = res.metrics
    regs = sorted(res.registered_views)
    c = camera_centers(res.state.cameras.cpu().numpy())[regs]
    g = scene.centers[regs]
    diam = float(np.linalg.norm(g.max(0) - g.min(0)))
    ate_frac = aligned_rmse(c, g) / diam if len(regs) >= 3 else float("nan")
    stages = {k: round(v, 3) for k, v in m.items() if k.startswith("t_")}
    print(f"V={n_views} stages (s): {json.dumps(stages)}")
    print(
        "V=%d quality: registered %d/%d, components %d (merged %d), RMS %.3f px, "
        "ATE %.4f%% of diameter, %d points, %.0f keypoints/image, knn2 launches %d"
        % (
            n_views, m["n_registered"], n_views, m["n_components"],
            m["n_merged_components"], m["ba_rms_px"], 100 * ate_frac, m["n_points"],
            m["n_keypoints_mean"], launches["knn2"],
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

    from sfm_danpipeline_torch import kernels

    t0 = time.time()
    kernels.load("knn2")  # nvcc from csrc/ at first use
    print(f"build: knn2 {time.time() - t0:.1f}s")
    knn2_row = check_knn2()
    launches = {}
    _, _, l4 = run_pipeline(10, 0.2, components=1)
    scene20, res20, l5 = run_pipeline(20, 0.4, components=2)
    l6 = run_dense(scene20, res20)
    for part in (l4, l5, l6):
        for name, n in part.items():
            launches[name] = launches.get(name, 0) + n
    print(json.dumps({"kernels": [{
        "name": "knn2",
        "route": "cuda",
        "source": "sfm_danpipeline_torch/csrc/knn2.cu",
        "replaces": "sfm_danpipeline_tpu/ops/matching.py:182",
        "launches": launches["knn2"],
        **knn2_row,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
