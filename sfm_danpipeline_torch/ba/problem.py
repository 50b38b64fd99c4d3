"""Bundle-adjustment problem representation.

Port of sfm_danpipeline_tpu/ba/problem.py: a flat observation table over
cameras (6-dof angle-axis + translation), one shared focal and world
points; observations have the principal point subtracted, and the
residual is f * perspective_divide(R X + t) - obs
(SimpleReprojectionError, src/BundleAdjustment.cpp:5-44).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class BAProblem:
    """cameras (C, 6), focal (), points (P, 3), obs_cam / obs_pt (O,) int,
    obs_xy (O, 2) pp-subtracted pixels, obs_w (O,) weights (0 = padding),
    fix_cam (C,) bool, fix_focal () bool, fix_pt (P,) bool or None."""

    cameras: torch.Tensor
    focal: torch.Tensor
    points: torch.Tensor
    obs_cam: torch.Tensor
    obs_pt: torch.Tensor
    obs_xy: torch.Tensor
    obs_w: torch.Tensor
    fix_cam: torch.Tensor
    fix_focal: torch.Tensor
    fix_pt: Optional[torch.Tensor] = None

    @property
    def n_cameras(self) -> int:
        return self.cameras.shape[0]

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_obs(self) -> int:
        return self.obs_cam.shape[0]


def make_problem(
    cameras: torch.Tensor,
    focal,
    points: torch.Tensor,
    obs_cam: torch.Tensor,
    obs_pt: torch.Tensor,
    obs_xy: torch.Tensor,
    obs_w: torch.Tensor,
    fix_cam: Optional[torch.Tensor] = None,
    fix_focal: bool = False,
) -> BAProblem:
    """A BAProblem from array-likes, in the field types BA expects (float32,
    int32 indices, bool masks) on the cameras' device; no camera is fixed
    unless `fix_cam` says so."""
    cameras = torch.as_tensor(cameras, dtype=torch.float32)
    dev = cameras.device

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev)

    if fix_cam is None:
        fix_cam = torch.zeros((cameras.shape[0],), dtype=torch.bool, device=dev)
    return BAProblem(
        cameras=cameras, focal=f32(focal), points=f32(points),
        obs_cam=i32(obs_cam), obs_pt=i32(obs_pt), obs_xy=f32(obs_xy), obs_w=f32(obs_w),
        fix_cam=torch.as_tensor(fix_cam, dtype=torch.bool, device=dev),
        fix_focal=torch.as_tensor(fix_focal, dtype=torch.bool, device=dev),
    )
