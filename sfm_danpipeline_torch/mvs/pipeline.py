"""Dense reconstruction driver: depth sweeps per registered view + fusion.

Port of sfm_danpipeline_tpu/mvs/pipeline.py, the in-process replacement of
the reference's PMVS2 stage: half-resolution (level 1) depth sweeps for
every registered view against its nearest registered neighbors, cross-view
consistency fusion and a voxel dedup. The sweeps and the fusion run as
torch ops on `device`; source choice, the depth range, the dedup and the
sparse-depth audit stay numpy on the host, as in the reference.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List

import numpy as np
import torch

from sfm_danpipeline_torch.config import MVSConfig
from sfm_danpipeline_torch.io.calibration import Intrinsics
from sfm_danpipeline_torch.io.images import ImageBatch
from sfm_danpipeline_torch.mvs.fusion import fuse_view, voxel_downsample
from sfm_danpipeline_torch.mvs.planesweep import make_depth_hypotheses, sweep_depth_map
from sfm_danpipeline_torch.mvs.rectsweep import rect_sweep_depth_map
from sfm_danpipeline_torch.ops.lie import exp_so3
from sfm_danpipeline_torch.ops.projection import undistort_image
from sfm_danpipeline_torch.pipeline.tracks import ReconstructionState

log = logging.getLogger("sfm_danpipeline_torch.mvs")


@dataclasses.dataclass
class DenseResult:
    points: np.ndarray
    colors: np.ndarray
    depth_maps: np.ndarray  # (V, H, W) at the working resolution
    metrics: Dict[str, float]


def _downsample(img: torch.Tensor, level: int) -> torch.Tensor:
    """2x2 box average `level` times over the last two axes."""
    for _ in range(level):
        img = 0.25 * (
            img[..., 0::2, 0::2] + img[..., 1::2, 0::2]
            + img[..., 0::2, 1::2] + img[..., 1::2, 1::2]
        )
    return img


def densify(
    images: ImageBatch,
    intrinsics: Intrinsics,
    state: ReconstructionState,
    config: MVSConfig = MVSConfig(),
    n_sources: int = 4,
    device: str | torch.device | None = None,
) -> DenseResult:
    """Dense cloud from a sparse reconstruction. `device` defaults to the
    state's device."""
    t_start = time.time()
    dev = state.device if device is None else torch.device(device)
    V = images.n_images
    scale = 0.5 ** config.level
    H = images.shape[0] >> config.level
    W = images.shape[1] >> config.level
    gray_full = torch.as_tensor(images.gray, device=dev)
    color_full = torch.as_tensor(images.color, device=dev)
    # SfM poses and points live in the ideal-pinhole gauge (keypoints are
    # canonicalized up front), so with nonzero distortion the sweep must
    # sample undistorted images.
    if bool(np.any(np.asarray(intrinsics.dist) != 0.0)):
        K_full = torch.as_tensor(intrinsics.K, dtype=torch.float32, device=dev)
        dist = torch.as_tensor(intrinsics.dist, dtype=torch.float32, device=dev)
        gray_full = torch.stack([undistort_image(im, K_full, dist) for im in gray_full])
        color_full = torch.stack([undistort_image(im, K_full, dist) for im in color_full])
    crop = (slice(None), slice(0, H << config.level), slice(0, W << config.level))
    gray = _downsample(gray_full[crop], config.level)
    color = _downsample(color_full[crop].permute(0, 3, 1, 2), config.level).permute(0, 2, 3, 1)
    K = torch.as_tensor(intrinsics.scaled(scale).K, dtype=torch.float32, device=dev)

    cameras = state.cameras.to(dev)
    cam_valid = state.camera_valid.cpu().numpy()
    registered: List[int] = [v for v in range(V) if cam_valid[v]]
    R_all = exp_so3(cameras[:, :3])
    t_all = cameras[:, 3:]
    R_np = R_all.cpu().numpy()
    t_np = t_all.cpu().numpy()
    centers = -np.einsum("vij,vi->vj", R_np, t_np)
    pts = state.points_xyz.cpu().numpy()
    pts_valid = state.points_valid.cpu().numpy()
    track_feat = state.track_feat.cpu().numpy()

    depth_maps = torch.zeros((V, H, W), dtype=torch.float32, device=dev)
    coverage: List[float] = []
    min_consistent = min(config.min_consistent_views, max(2, len(registered) - 1))

    for r in registered:
        # Nearest registered sources by camera-center distance.
        others = [v for v in registered if v != r]
        others.sort(key=lambda v: np.linalg.norm(centers[v] - centers[r]))
        srcs = others[:n_sources]
        if not srcs:
            continue
        # Depths of the sparse points in this camera.
        z = pts @ R_np[r].T[:, 2] + t_np[r, 2]
        z = np.where(pts_valid, z, -1.0)
        R_rs = torch.stack([R_all[s] @ R_all[r].T for s in srcs])
        t_rs = torch.stack([t_all[s] - R_all[s] @ R_all[r].T @ t_all[r] for s in srcs])
        src_valid = torch.ones(len(srcs), dtype=torch.bool, device=dev)
        if config.method == "rectified":
            # Depth range from points with a live observation in view r
            # (all points in front of it when too few are observed).
            obs_r = (track_feat[:, r] >= 0) & pts_valid
            z_obs = z[obs_r & (z > 0)] if obs_r.any() else z[z > 0]
            zv = z_obs if len(z_obs) >= 32 else z[z > 0]
            lo = float(np.percentile(zv, 5.0)) if len(zv) else 1.0
            hi = float(np.percentile(zv, 95.0)) if len(zv) else 10.0
            dm = rect_sweep_depth_map(
                gray[r], gray[srcs], K, R_rs, t_rs, src_valid,
                float(np.float32(max(0.6 * lo, 1e-3))), float(np.float32(1.4 * hi)),
                min_score=config.ncc_threshold, n_depths=config.n_depth_planes,
                window=config.window_size,
            )
        else:
            depths = make_depth_hypotheses(
                torch.as_tensor(z, dtype=torch.float32, device=dev), config.n_depth_planes
            )
            dm = sweep_depth_map(
                gray[r], gray[srcs], K, R_rs, t_rs, src_valid, depths,
                min_score=config.ncc_threshold, window=config.window_size,
            )
        depth_maps[r] = dm.depth
        coverage.append(float((dm.depth > 0).float().mean()))
        log.info(
            "view %d: %.0f%% pixels pass NCC>=%.2f",
            r, 100.0 * coverage[-1], config.ncc_threshold,
        )

    # Fusion.
    cam_valid_t = torch.as_tensor(cam_valid, device=dev)
    all_pts, all_cols = [], []
    for r in registered:
        fused = fuse_view(
            r, depth_maps, color, R_all, t_all, K, cam_valid_t,
            min_consistent=min_consistent, depth_consistency=config.depth_consistency,
        )
        all_pts.append(fused.points[fused.valid].cpu().numpy())
        all_cols.append(fused.colors[fused.valid].cpu().numpy())
    points = np.concatenate(all_pts) if all_pts else np.zeros((0, 3), np.float32)
    colors = np.concatenate(all_cols) if all_cols else np.zeros((0, 3), np.float32)
    # Voxel dedup at ~the sparse merge radius scaled by scene size.
    if len(points):
        bbox = np.percentile(points, [2, 98], axis=0)
        voxel = float(np.linalg.norm(bbox[1] - bbox[0])) / 400.0
        points, colors = voxel_downsample(points, colors, max(voxel, 1e-6))

    # Sparse-consistency audit: median relative depth error of the dense
    # maps at the pixels of observed sparse tracks, pooled over views.
    depth_np = depth_maps.cpu().numpy()
    K_np = K.cpu().numpy()
    errs = []
    n_audit = 0
    for r in registered:
        obs = (track_feat[:, r] >= 0) & pts_valid
        if not obs.any():
            continue
        cam = pts[obs] @ R_np[r].T + t_np[r]
        z = cam[:, 2]
        ok = z > 1e-6
        with np.errstate(divide="ignore", invalid="ignore"):
            u = K_np[0, 0] * cam[:, 0] / z + K_np[0, 2]
            v = K_np[1, 1] * cam[:, 1] / z + K_np[1, 2]
        ui = np.round(np.nan_to_num(u)).astype(np.int64)
        vi = np.round(np.nan_to_num(v)).astype(np.int64)
        inb = ok & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        d = depth_np[r][vi[inb], ui[inb]]
        zz = z[inb]
        m = d > 0
        n_audit += int(m.sum())
        if m.any():
            errs.append(np.abs(d[m] - zz[m]) / zz[m])
    med_err = float(np.median(np.concatenate(errs))) if errs else 1.0
    metrics = {
        "n_dense_points": float(len(points)),
        "n_views_swept": float(len(registered)),
        "sparse_depth_med_rel_err": med_err,
        "sparse_depth_n_audited": float(n_audit),
        # Mean fraction of pixels whose depth passed the photometric
        # threshold and the source consensus.
        "depth_coverage": float(np.mean(coverage)) if coverage else 0.0,
        "t_dense": time.time() - t_start,
    }
    log.info(
        "dense: %d points from %d views in %.1fs "
        "(sparse-consistency %.2f%% median rel err over %d pixels)",
        len(points), len(registered), metrics["t_dense"], 100.0 * med_err, n_audit,
    )
    return DenseResult(
        points=points.astype(np.float32),
        colors=colors.astype(np.float32),
        depth_maps=depth_np,
        metrics=metrics,
    )
