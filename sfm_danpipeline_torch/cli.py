"""Command-line entry point of the PyTorch port.

    python -m sfm_danpipeline_torch.cli --images DIR --calibration XML \
        --output OUT [--stages sfm,dense,filter,mesh,segment,dendrometry] \
        [--detector sift|akaze|orb] [--matcher bf|flow] [--checkpoint FILE] \
        [--device cuda|cpu] [--coordinator HOST:PORT --num-processes N
        --process-id I]

Port of sfm_danpipeline_tpu/cli.py: the reference's 3-stage flow
(main.cpp:18-87: SfM map, segmentation, dendrometry) plus the dense, filter
and mesh stages, with artifact files in place of the blocking viewers:
sparse.ply, cameras.json, dense.ply, MAP3D.pcd, filtered.ply, mesh.obj,
segmentation_labels.npy, dendrometry.json, metrics.jsonl. Same flags,
defaults, stage order, gauge guards and exit codes, on the CUDA card unless
`--device cpu` is given. `main` parses and loads; `run_stages` runs the
stages on in-memory images, so a caller without image files (or without
PIL) can drive every stage.

metrics.jsonl gets one JSON record per line, each with its "stage" and a
"ts": one per stage run (that stage's metrics), "timing" (each stage's
wall seconds as t_<stage>) and, after the sfm stage, "trace": the run's
trace from inside `SfMPipeline.run` (utils/profiling.py). Its "spans" are
{run, index, parent, name, start_ns, end_ns, attrs}, nested by "parent"
(-1 for the root "set"), on the wall clock of `time.time_ns()`: the stages
(features, matching, baseline, incremental, components, final_ba) and the
steps under them (baseline.score, seed, seed.basin, pnp, triangulate, ba,
merge). Its "counters" count seed basins tried and accepted
(seed_basins, seed_basins_accepted), seeds validated by a third view
(seeds_validated), PnP attempts and failures (pnp_attempts, pnp_failed),
and BA solves and their LM iterations (ba_solves, lm_iterations).

Multi-process mode: launch one process per rank with the same arguments plus
`--coordinator HOST:PORT --num-processes N --process-id I`. Each process
joins the job (parallel/distributed.initialize, before anything touches the
card) and the sfm stage runs parallel/distributed.run_sfm_multihost: sharded
features and matching, the incremental loop on rank 0, the broadcast, and
the multi-process polish. Every rank then runs the later stages on the same
reconstruction and writes its own artifacts under `--output`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from sfm_danpipeline_torch import require_device
from sfm_danpipeline_torch.config import PipelineConfig
from sfm_danpipeline_torch.io.calibration import Intrinsics
from sfm_danpipeline_torch.io.images import ImageBatch
from sfm_danpipeline_torch.io.native import write_ply_fast as write_ply
from sfm_danpipeline_torch.io.ply import write_pcd
from sfm_danpipeline_torch.utils.checkpoint import load_state, save_state
from sfm_danpipeline_torch.utils.profiling import StageTimer

log = logging.getLogger("cli")

STAGES = ("sfm", "dense", "filter", "mesh", "segment", "dendrometry")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="itree3dmap-torch",
        description="Incremental Structure-from-Motion on PyTorch / CUDA",
    )
    p.add_argument("--images", required=True, help="image directory")
    p.add_argument(
        "--calibration", required=True, help="OpenCV XML calibration file"
    )
    p.add_argument("--output", default="out", help="output directory")
    p.add_argument(
        "--stages",
        default="sfm,dense,filter,segment,dendrometry",
        help="comma-separated stages: sfm,dense,filter,mesh,segment,"
        "dendrometry",
    )
    p.add_argument("--max-points", type=int, default=16384)
    p.add_argument("--max-keypoints", type=int, default=2048)
    p.add_argument(
        "--detector", choices=["sift", "akaze", "orb"], default="sift",
        help="feature detector (reference's selector, include/Sfm.h:40-61)",
    )
    p.add_argument(
        "--matcher", choices=["bf", "flow"], default="bf",
        help="bf = descriptor kNN + ratio; flow = pyramidal LK tracking",
    )
    p.add_argument(
        "--ratio", type=float, default=None,
        help="Lowe ratio (default: 0.8 for SIFT per include/Sfm.h:60; 0.9 "
        "for the binary AKAZE/ORB descriptors, which need a looser test)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--viz", action="store_true",
        help="dump visualization PNGs (keypoints, baseline matches, cloud "
        "views, depth maps): the artifact form of the reference's "
        "blocking viewers (src/Sfm.cpp:276-296,416-464,1385-1397); needs "
        "PIL and matplotlib",
    )
    p.add_argument(
        "--no-ba-every-view", action="store_true",
        help="only run the final global bundle adjustment",
    )
    p.add_argument(
        "--checkpoint", default=None,
        help="path to save/load the reconstruction state (resume support)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device of every stage (default: the CUDA card; fails "
        "without one unless 'cpu' is given)",
    )
    p.add_argument(
        "--coordinator", default=None, metavar="HOST:PORT",
        help="multi-process mode: the rendezvous address (a tcp:// store "
        "there; any free port on rank 0's host). Launch one process per rank "
        "with identical arguments plus --num-processes / --process-id; the "
        "sfm stage then runs the sharded input stages, rank 0's incremental "
        "loop and the multi-process polish (parallel/distributed."
        "run_sfm_multihost)",
    )
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument(
        "--sharded-min-obs", type=int, default=None,
        help="observations from which a global bundle adjustment runs "
        "sharded (the multi-process polish; the final BA over several "
        "cards); default: the config's ba.sharded_min_obs",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def config_from_args(args: argparse.Namespace) -> PipelineConfig:
    cfg = PipelineConfig()
    # Per-detector strict ratio: binary MLDB/BRIEF descriptors (AKAZE/ORB)
    # need a looser Lowe test than SIFT's 0.8 (include/Sfm.h:60).
    ratio = args.ratio
    if ratio is None:
        ratio = 0.9 if args.detector in ("akaze", "orb") else 0.8
    return dataclasses.replace(
        cfg,
        max_points=args.max_points,
        features=dataclasses.replace(
            cfg.features, max_keypoints=args.max_keypoints, detector=args.detector
        ),
        matching=dataclasses.replace(cfg.matching, ratio=ratio, method=args.matcher),
        geometry=dataclasses.replace(cfg.geometry, seed=args.seed),
        ba=dataclasses.replace(
            cfg.ba, sharded_min_obs=(
                cfg.ba.sharded_min_obs if args.sharded_min_obs is None else args.sharded_min_obs
            ),
        ),
    )


@dataclasses.dataclass
class StagesRun:
    """What `run_stages` produced: the exit code and, for callers that go on
    working with them, the in-memory results of the stages that ran."""

    code: int
    sfm: Optional[object] = None  # pipeline.sfm.SfMResult
    state: Optional[object] = None  # the reconstruction state (run or resumed)
    dense: Optional[object] = None  # mvs.pipeline.DenseResult


def run_stages(
    images: ImageBatch,
    intrinsics: Intrinsics,
    cfg: PipelineConfig,
    output: str,
    stages: Sequence[str],
    device: str | torch.device = "cuda",
    checkpoint: Optional[str] = None,
    viz: bool = False,
    run_ba_every_view: bool = True,
    distributed: bool = False,
) -> StagesRun:
    """Run `stages` (any of STAGES, in the fixed stage order) on in-memory
    images and write every artifact under `output`. `distributed`: the
    process has joined a multi-process job (parallel/distributed.initialize)
    and the sfm stage runs run_sfm_multihost."""
    dev = require_device(device)
    unknown = [s for s in stages if s not in STAGES]
    if unknown:
        raise ValueError(f"unknown stage(s) {unknown}; choose from {list(STAGES)}")
    os.makedirs(output, exist_ok=True)
    run = StagesRun(code=0)
    timer = StageTimer()
    with open(os.path.join(output, "metrics.jsonl"), "a") as mfile:

        def emit(stage: str, payload: dict):
            rec = {"stage": stage, "ts": time.time(), **payload}
            mfile.write(json.dumps(rec) + "\n")
            mfile.flush()

        run.code = _run_stages(
            run, images, intrinsics, cfg, output, stages, dev, checkpoint, viz,
            run_ba_every_view, distributed, emit, timer,
        )
        emit("timing", timer.as_metrics())
    return run


def _run_stages(
    run, images, intrinsics, cfg, output, stages, dev, checkpoint, viz,
    run_ba_every_view, distributed, emit, timer,
) -> int:
    points = colors = None
    state = None
    dres = None

    if "sfm" not in stages and checkpoint and os.path.exists(checkpoint):
        # Resume: analysis/dense stages run from a saved reconstruction.
        state, _ = load_state(checkpoint, device=dev)
        valid = state.points_valid.cpu().numpy()
        points = state.points_xyz.cpu().numpy()[valid]
        colors = state.points_rgb.cpu().numpy()[valid]
        log.info("resumed %d points from %s", len(points), checkpoint)

    if "sfm" in stages:
        from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline

        with timer.stage("sfm"):
            # checkpoint_path enables per-view mid-run checkpointing and
            # auto-resume from a previous kill.
            if distributed:
                from sfm_danpipeline_torch.parallel import distributed as D

                res = D.run_sfm_multihost(
                    images, intrinsics, cfg, run_ba_every_view=run_ba_every_view,
                    checkpoint_path=checkpoint, device=dev,
                )
            else:
                res = SfMPipeline(cfg, checkpoint_path=checkpoint, device=dev).run(
                    images, intrinsics, run_ba_every_view=run_ba_every_view
                )
        run.sfm = res
        state = res.state
        points, colors = res.points, res.colors
        emit("sfm", res.metrics)
        if res.trace is not None:  # a rank that ran no SfMPipeline.run has none
            emit("trace", res.trace)
        write_ply(os.path.join(output, "sparse.ply"), points, colors)
        if viz:
            from sfm_danpipeline_torch.utils import viz as vz

            vdir = os.path.join(output, "viz")
            os.makedirs(vdir, exist_ok=True)
            kp = res.keypoints
            # Raw detections align with the raw (possibly distorted) images;
            # kp.xy is canonicalized to ideal pixels.
            draw_xy = res.raw_xy if res.raw_xy is not None else kp.xy.cpu().numpy()
            kp_valid = kp.valid.cpu().numpy()
            for i in range(images.n_images):
                vz.draw_keypoints(
                    os.path.join(vdir, f"keypoints_{i:04d}.png"),
                    np.asarray(images.color[i]), draw_xy[i], kp_valid[i],
                )
            if res.baseline_matches is not None:
                bi = int(res.metrics["baseline_pair_i"])
                bj = int(res.metrics["baseline_pair_j"])
                xa, xb, mv = res.baseline_matches
                vz.draw_matches(
                    os.path.join(vdir, f"matches_{bi:04d}_{bj:04d}.png"),
                    np.asarray(images.color[bi]), np.asarray(images.color[bj]),
                    xa, xb, mv,
                )
            vz.save_cloud_views(os.path.join(vdir, "sparse_cloud.png"), points, colors)
            log.info("viz: artifacts in %s", vdir)
        cams = {
            "registered_views": res.registered_views,
            "focal": float(state.focal),
            "cameras": state.cameras.cpu().numpy().tolist(),
        }
        with open(os.path.join(output, "cameras.json"), "w") as f:
            json.dump(cams, f, indent=1)
        if checkpoint:
            save_state(checkpoint, state)
        log.info("sfm: %d points -> sparse.ply", len(points))
    run.state = state

    if "dense" in stages:
        from sfm_danpipeline_torch.mvs.pipeline import densify

        if state is None:
            log.error("dense stage requires sfm stage (or a checkpoint)")
            return 1
        with timer.stage("dense"):
            dres = densify(images, intrinsics, state, cfg.mvs, device=dev)
        run.dense = dres
        points, colors = dres.points, dres.colors
        emit("dense", dres.metrics)
        write_ply(os.path.join(output, "dense.ply"), points, colors)
        # MAP3D.pcd: the reference's on-disk artifact (src/Sfm.cpp:80).
        write_pcd(os.path.join(output, "MAP3D.pcd"), points, colors)
        log.info("dense: %d points -> dense.ply, MAP3D.pcd", len(points))
        if viz:
            from sfm_danpipeline_torch.utils import viz as vz

            vdir = os.path.join(output, "viz")
            os.makedirs(vdir, exist_ok=True)
            for i, dm in enumerate(np.asarray(dres.depth_maps)):
                vz.save_depth_map(os.path.join(vdir, f"depth_{i:04d}.png"), dm)
            vz.save_cloud_views(os.path.join(vdir, "dense_cloud.png"), points, colors)

    if "filter" in stages and points is not None and len(points) > 0:
        # Cloud filtering between dense and mesh/segment: the reference's
        # cloudPointFilter + removePoints (src/Sfm.cpp:1323-1345). Its
        # PassThrough window and outlier radius are in the reference's
        # metric gauge; SfM output lives in an arbitrary gauge, so each
        # filter is gated: when it would discard nearly the whole cloud it
        # is the wrong frame and is skipped (same guard as segmentation's
        # z-window below).
        from sfm_danpipeline_torch.analysis.filtering import (
            passthrough_mask,
            radius_outlier_mask,
        )

        with timer.stage("filter"):
            a = cfg.analysis
            n0 = len(points)
            pts_t = torch.as_tensor(points, dtype=torch.float32, device=dev)
            valid = torch.ones(n0, dtype=torch.bool, device=dev)
            m = passthrough_mask(
                pts_t, a.passthrough_axis, a.passthrough_min, a.passthrough_max, valid
            )
            kept = float(m.to(torch.float32).mean())
            if kept >= 0.05:
                valid = m
            else:
                log.warning(
                    "filter: PassThrough %s in [%g, %g] keeps %.2f%% — wrong "
                    "gauge; skipping it",
                    a.passthrough_axis, a.passthrough_min, a.passthrough_max, 100.0 * kept,
                )
            # Radius-outlier removal scaled to the cloud: the reference's
            # absolute r=0.07 assumes its gauge; use it when sane, else fall
            # back to 1% of the bounding-box diagonal with a small neighbor
            # minimum.
            diag = float(np.linalg.norm(points.max(0) - points.min(0)))
            radius, min_nb = a.outlier_radius, a.outlier_min_neighbors
            m = radius_outlier_mask(pts_t, valid, radius, min_nb)
            # The fallback trigger compares against the PassThrough-surviving
            # count, not the pre-filter total.
            if float(m.sum()) < 0.05 * float(valid.sum()):
                radius, min_nb = 0.01 * diag, 3
                m = radius_outlier_mask(pts_t, valid, radius, min_nb)
                log.warning(
                    "filter: reference radius-outlier params keep too little; "
                    "using r=%.4g, >=%d neighbors", radius, min_nb,
                )
            keep = m.cpu().numpy()
        points = points[keep]
        if colors is not None:
            colors = colors[keep]
        emit("filter", {"n_before": n0, "n_after": int(keep.sum())})
        log.info("filter: %d -> %d points", n0, int(keep.sum()))
        write_ply(os.path.join(output, "filtered.ply"), points, colors)

    if "mesh" in stages:
        # Reference meshing stage (src/Sfm.cpp:1347-1383); here TSDF +
        # marching tetrahedra over the dense depth maps.
        if dres is None or state is None:
            log.warning("mesh stage requires the dense stage; skipping")
        else:
            from sfm_danpipeline_torch.mvs.meshing import mesh_from_depth_maps, write_obj
            from sfm_danpipeline_torch.ops.lie import exp_so3

            with timer.stage("mesh"):
                scale = 0.5 ** cfg.mvs.level
                mesh = mesh_from_depth_maps(
                    np.asarray(dres.depth_maps),
                    exp_so3(state.cameras[:, :3]).cpu().numpy(),
                    state.cameras[:, 3:].cpu().numpy(),
                    intrinsics.scaled(scale).K,
                    state.camera_valid.cpu().numpy(),
                    grid=2 ** cfg.analysis.mesh_poisson_depth,
                    device=dev,
                )
            write_obj(os.path.join(output, "mesh.obj"), mesh)
            emit("mesh", {"n_vertices": len(mesh.vertices), "n_faces": len(mesh.faces)})
            log.info(
                "mesh: %d verts, %d faces -> mesh.obj", len(mesh.vertices), len(mesh.faces)
            )

    if points is None:
        log.error("no cloud produced/loaded; nothing to analyze")
        return 1

    if "segment" in stages:
        from sfm_danpipeline_torch.analysis.segmentation import segment_cloud

        # The reference hard-codes a z in [0,14] pass-through for its
        # agisoft tree clouds (src/Segmentation.cpp:24-28). SfM output lives
        # in an arbitrary gauge, so when the window would discard nearly the
        # whole cloud it is clearly the wrong frame: disable it rather than
        # reproduce the reference's exit-on-empty failure mode.
        a = cfg.analysis
        z_min, z_max = a.seg_z_min, a.seg_z_max
        z = points[:, 2]
        kept = float(np.mean((z >= z_min) & (z <= z_max)))
        if kept < 0.05:
            log.warning(
                "segment: z-window [%g, %g] keeps %.2f%% of the cloud — "
                "cloud is in a different gauge; disabling the pass-through",
                z_min, z_max, 100.0 * kept,
            )
            z_min, z_max = -np.inf, np.inf
        with timer.stage("segment"):
            seg = segment_cloud(
                torch.as_tensor(points, dtype=torch.float32, device=dev),
                torch.as_tensor(
                    colors if colors is not None else np.zeros_like(points),
                    dtype=torch.float32, device=dev,
                ),
                torch.ones(len(points), dtype=torch.bool, device=dev),
                z_min=z_min,
                z_max=z_max,
                distance=a.seg_distance,
                point_color=a.seg_point_color,
                region_color=a.seg_region_color,
                min_cluster=min(a.seg_min_cluster, max(len(points) // 10, 1)),
            )
        n = int(seg.n_clusters)
        emit("segment", {"n_clusters": n})
        np.save(os.path.join(output, "segmentation_labels.npy"), seg.labels.cpu().numpy())
        if n == 0:
            # Reference exits on zero clusters (src/Segmentation.cpp:44-48).
            log.error("segmentation found 0 clusters")
            return 1
        log.info("segmentation: %d clusters", n)

    if "dendrometry" in stages:
        from sfm_danpipeline_torch.analysis.dendrometry import estimate

        with timer.stage("dendrometry"):
            rep = estimate(
                torch.as_tensor(points, dtype=torch.float32, device=dev),
                torch.ones(len(points), dtype=torch.bool, device=dev),
            )
        emit("dendrometry", rep)
        with open(os.path.join(output, "dendrometry.json"), "w") as f:
            json.dump(rep, f, indent=1)
        log.info("dendrometry: total height %.3f", rep["total_height"])
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname).1s %(name)s: %(message)s",
    )
    from sfm_danpipeline_torch.io.calibration import load_calibration
    from sfm_danpipeline_torch.io.images import load_images

    device = require_device(args.device)  # before any loading: no card, no run
    distributed = args.coordinator is not None
    if distributed:
        if args.num_processes is None or args.process_id is None:
            raise SystemExit("--coordinator needs --num-processes and --process-id")
        from sfm_danpipeline_torch.parallel import distributed as D

        # Joins the job and picks this rank's card before anything touches it.
        device = D.initialize(args.coordinator, args.num_processes, args.process_id, device)
    try:
        stages = [s.strip() for s in args.stages.split(",") if s.strip()]
        cfg = config_from_args(args)
        images = load_images(args.images, cfg.images)
        intrinsics = load_calibration(args.calibration)
        log.info("%d images @ %s, fx=%.1f", images.n_images, images.shape, intrinsics.fx)
        run = run_stages(
            images, intrinsics, cfg, args.output, stages, device=device,
            checkpoint=args.checkpoint, viz=args.viz,
            run_ba_every_view=not args.no_ba_every_view, distributed=distributed,
        )
        if distributed and run.sfm is not None:
            log.info("rank %d: %s", args.process_id, rank_summary(run.sfm))
        return run.code
    finally:
        if distributed:
            D.shutdown()


def rank_summary(res) -> str:
    """One line that tells the ranks' reconstructions apart: the registered
    views, the sum of the cameras, the point count, and how often the knn2
    kernel was launched in this process."""
    from sfm_danpipeline_torch.ops.matching import knn2

    return (
        f"registered {res.registered_views} camera sum "
        f"{float(res.state.cameras.double().sum()):.9e} points {len(res.points)} "
        f"backend {res.metrics.get('dist_backend')} knn2 launches {knn2.launches}"
    )


if __name__ == "__main__":
    sys.exit(main())
