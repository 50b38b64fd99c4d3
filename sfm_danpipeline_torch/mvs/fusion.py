"""Multi-view depth-map fusion into a dense colored cloud.

Port of sfm_danpipeline_tpu/mvs/fusion.py, the analogue of PMVS2's patch
filtering and its minImageNum visibility requirement: a depth-map pixel
survives only if its 3D point reprojects into >= `min_consistent` other
views with relative depth agreement better than `depth_consistency`. The
final dedup is a voxel-grid unique on the host.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from sfm_danpipeline_torch.mvs.planesweep import _pixel_grid
from sfm_danpipeline_torch.ops.interp import bilinear_sample_level


class FusedCloud(NamedTuple):
    points: torch.Tensor  # (H*W, 3)
    colors: torch.Tensor  # (H*W, 3)
    valid: torch.Tensor  # (H*W,)


def fuse_view(
    ref_idx: int,
    depths: torch.Tensor,  # (V, H, W) all depth maps (0 = invalid)
    colors: torch.Tensor,  # (V, H, W, 3)
    R: torch.Tensor,  # (V, 3, 3) world->cam
    t: torch.Tensor,  # (V, 3)
    K: torch.Tensor,
    cam_valid: torch.Tensor,  # (V,)
    min_consistent: int = 2,
    depth_consistency: float = 0.01,
) -> FusedCloud:
    """Backproject one view's depth map and keep the pixels consistent with
    enough other views, all views checked in one batched pass."""
    V, H, W = depths.shape
    d_ref = depths[ref_idx]
    ys, xs = _pixel_grid(H, W, depths.device)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    xn = (xs - cx) / fx
    yn = (ys - cy) / fy
    cam_pts = torch.stack([xn * d_ref, yn * d_ref, d_ref], dim=-1)  # (H, W, 3)
    world = (cam_pts - t[ref_idx]) @ R[ref_idx]  # R^T (x - t)

    cam_s = torch.einsum("hwj,vij->vhwi", world, R) + t[:, None, None, :]  # (V, H, W, 3)
    z = cam_s[..., 2]
    zsafe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam_s[..., 0] / zsafe * fx + cx
    v = cam_s[..., 1] / zsafe * fy + cy
    inside = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1) & (z > 0)
    level = torch.arange(V, device=depths.device)[:, None, None]
    d_s = bilinear_sample_level(depths, level, u, v)
    rel = torch.abs(d_s - z) / torch.clamp(z, min=1e-9)
    usable = cam_valid & (torch.arange(V, device=depths.device) != ref_idx)
    ok = inside & (d_s > 0) & (rel < depth_consistency) & usable[:, None, None]
    keep = (d_ref > 0) & (torch.sum(ok, dim=0) >= min_consistent)
    return FusedCloud(
        points=world.reshape(-1, 3),
        colors=colors[ref_idx].reshape(-1, 3),
        valid=keep.reshape(-1),
    )


def voxel_downsample(
    points: np.ndarray, colors: np.ndarray, voxel: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side voxel-grid dedup: the first point (in input order) of
    every occupied voxel, kept in input order."""
    if len(points) == 0:
        return points, colors
    keys = np.floor(np.ascontiguousarray(points, np.float32) / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    idx = np.sort(idx)
    return points[idx], colors[idx]
