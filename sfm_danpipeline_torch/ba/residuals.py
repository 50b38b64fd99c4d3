"""BA residuals and per-observation Jacobian blocks.

Port of sfm_danpipeline_tpu/ba/residuals.py. The reference's
`jax.jacfwd` of the per-observation residual, vmapped over the table,
becomes `torch.func.jacfwd` under `torch.func.vmap`.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.func import jacfwd, vmap

from sfm_danpipeline_torch.ops.lie import rotate_point


def _residual_one(cam, focal, X, obs):
    """(2,) residual of one observation; cam (6,) = [angle-axis, t]."""
    p = rotate_point(cam[:3], X) + cam[3:]
    z = torch.where(torch.abs(p[2]) < 1e-9, torch.full_like(p[2], 1e-9), p[2])
    return focal * (p[:2] / z) - obs


def residuals(cameras, focal, points, obs_cam, obs_pt, obs_xy, obs_w) -> torch.Tensor:
    """(O, 2) weighted residuals for the whole observation table."""
    cam = cameras[obs_cam]
    p = rotate_point(cam[:, :3], points[obs_pt]) + cam[:, 3:]
    z = torch.where(torch.abs(p[:, 2:3]) < 1e-9, torch.full_like(p[:, 2:3], 1e-9), p[:, 2:3])
    return (focal * (p[:, :2] / z) - obs_xy) * obs_w[:, None]


def cost(cameras, focal, points, obs_cam, obs_pt, obs_xy, obs_w) -> torch.Tensor:
    """Total squared reprojection cost 0.5 * sum r^2 (the LM objective)."""
    r = residuals(cameras, focal, points, obs_cam, obs_pt, obs_xy, obs_w)
    return 0.5 * torch.sum(r * r)


def jacobian_blocks(
    cameras, focal, points, obs_cam, obs_pt, obs_xy, obs_w
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(r (O,2), Jc (O,2,6), Jf (O,2,1), Jp (O,2,3)), pre-weighted by obs_w."""

    def one(cam, X, obs, w):
        def f(c, fo, x):
            return _residual_one(c, fo, x, obs) * w

        Jc, Jf, Jp = jacfwd(f, argnums=(0, 1, 2))(cam, focal, X)
        return f(cam, focal, X), Jc, Jf.reshape(2, 1), Jp

    return vmap(one)(cameras[obs_cam], points[obs_pt], obs_xy, obs_w)
