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

    python3 tools/torch_stage_probe.py determinism-audit

runs the four V=10 paths (SIFT, every command-line stage with AKAZE, ORB, LK
flow) under torch.use_deterministic_algorithms(True, warn_only=True) and
prints every operation PyTorch warns about. A run may end differently under
that setting (cuBLAS takes another workspace, so last bits differ); the audit
reports it, goes on, and exits 1 if any run stopped.

    python3 tools/torch_stage_probe.py flow-seeds [--seeds 0 1 2 ...]

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


def flow_seeds(seeds):
    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline

    scene = _scene(0.05)
    base = _config("sift", "flow")
    ates = []
    for seed in seeds:
        cfg = dataclasses.replace(base, geometry=dataclasses.replace(base.geometry, seed=seed))
        try:
            res = SfMPipeline(cfg, device="cuda").run(scene.images, scene.intrinsics)
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
    ap.add_argument("mode", choices=["time-stages", "determinism-audit", "flow-seeds"])
    ap.add_argument("--root", default=HERE, help="checkout whose sfm_danpipeline_torch is run")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_stage_probe: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    if args.mode == "time-stages":
        return time_stages()
    if args.mode == "determinism-audit":
        return determinism_audit()
    return flow_seeds(args.seeds)


if __name__ == "__main__":
    sys.exit(main())
