"""Synthetic textured scenes with exact ground-truth cameras.

A copy of sfm_danpipeline_tpu/utils/synthscene.py (numpy only), kept so
the port never imports the JAX package; tests/test_torch_drift.py holds
the rendered arrays bitwise equal to the original's.

Purpose: end-to-end SCALE benchmarks and loop-closure tests past the
10-image temple fixture (the reference ships only data/temple) — the
full pipeline (SIFT -> O(V^2) matching
-> incremental PnP -> rotation-averaging reinit -> final BA) needs
image-derived correspondences at V >= 50 to exercise its scale machinery
(pair-grid sharding, sharded BA routing, rotavg at >= 16 views) on inputs
it cannot memorize.

Scene: a square textured "courtyard" — four walls, floor and ceiling —
with cameras on an inner ring looking radially outward. Adjacent views
overlap heavily, the ring closes after 360 degrees (a genuine
loop-closure problem with translation parallax, not a rotation panorama:
the ring radius is a sizable fraction of the wall distance). Rendering is
exact ray-plane intersection with bilinear texture lookup — no mesh, no
renderer dependency; multi-scale smoothed-noise textures give SIFT
thousands of stable blobs per view.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from sfm_danpipeline_torch.io.calibration import Intrinsics
from sfm_danpipeline_torch.io.images import ImageBatch


def _texture(rng: np.random.Generator, n: int = 1024) -> np.ndarray:
    """Multi-scale smoothed noise in [0, 1] — blob structure at several
    frequencies so the DoG pyramid finds keypoints at every octave."""
    tex = np.zeros((n, n), np.float32)
    for scale, amp in ((8, 0.5), (32, 0.9), (128, 1.3)):
        coarse = rng.uniform(-1.0, 1.0, (scale, scale)).astype(np.float32)
        # Bilinear upsample to n x n.
        idx = np.linspace(0, scale - 1, n)
        i0 = np.clip(idx.astype(np.int64), 0, scale - 2)
        f = (idx - i0).astype(np.float32)
        rows = (
            coarse[i0] * (1 - f[:, None]) + coarse[i0 + 1] * f[:, None]
        )
        tex += amp * (
            rows[:, i0] * (1 - f[None, :]) + rows[:, i0 + 1] * f[None, :]
        )
    tex -= tex.min()
    tex /= max(tex.max(), 1e-6)
    return tex


@dataclasses.dataclass
class SynthScene:
    images: ImageBatch
    intrinsics: Intrinsics
    R: np.ndarray  # (V, 3, 3) world->cam ground truth
    t: np.ndarray  # (V, 3)
    centers: np.ndarray  # (V, 3)


def make_courtyard_scene(
    n_views: int = 50,
    height: int = 480,
    width: int = 640,
    seed: int = 0,
    ring_fraction: float = 1.0,
    ring_radius: float = 4.0,
    room_half: float = 10.0,
) -> SynthScene:
    """Render `n_views` cameras on a radius-`ring_radius` ring inside a
    2*`room_half`-wide textured room. `ring_fraction` < 1 opens the ring
    (an arc); 1.0 closes it (loop closure)."""
    rng = np.random.default_rng(seed)
    f = 520.0
    cx, cy = width / 2.0, height / 2.0
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]], np.float64)

    h = room_half
    wall_y = 6.0  # room half-height
    # Planes: (origin P0, unit normal, in-plane u-axis, v-axis, extents).
    planes = [
        # walls at x = +-h, z = +-h
        (np.array([h, 0.0, 0.0]), np.array([-1.0, 0, 0]),
         np.array([0, 0, 1.0]), np.array([0, 1.0, 0]), (h, wall_y)),
        (np.array([-h, 0.0, 0.0]), np.array([1.0, 0, 0]),
         np.array([0, 0, -1.0]), np.array([0, 1.0, 0]), (h, wall_y)),
        (np.array([0.0, 0.0, h]), np.array([0, 0, -1.0]),
         np.array([-1.0, 0, 0]), np.array([0, 1.0, 0]), (h, wall_y)),
        (np.array([0.0, 0.0, -h]), np.array([0, 0, 1.0]),
         np.array([1.0, 0, 0]), np.array([0, 1.0, 0]), (h, wall_y)),
        # floor / ceiling
        (np.array([0.0, -wall_y, 0.0]), np.array([0, 1.0, 0]),
         np.array([1.0, 0, 0]), np.array([0, 0, 1.0]), (h, h)),
        (np.array([0.0, wall_y, 0.0]), np.array([0, -1.0, 0]),
         np.array([1.0, 0, 0]), np.array([0, 0, -1.0]), (h, h)),
    ]
    textures = [_texture(rng) for _ in planes]

    ys, xs = np.mgrid[0:height, 0:width]
    rays_cam = np.stack(
        [(xs - cx) / f, (ys - cy) / f, np.ones_like(xs, np.float64)], -1
    ).reshape(-1, 3)

    gray = np.zeros((n_views, height, width), np.float32)
    R_all = np.zeros((n_views, 3, 3))
    t_all = np.zeros((n_views, 3))
    C_all = np.zeros((n_views, 3))
    for v in range(n_views):
        ang = ring_fraction * 2.0 * np.pi * v / n_views
        C = ring_radius * np.array([np.sin(ang), 0.0, np.cos(ang)])
        C[1] = 0.4 * np.sin(3.0 * ang)  # mild vertical wobble
        # Look outward with a fixed yaw offset: a camera looking straight
        # at one flat wall sees a PLANAR scene (epipolar H/E and DLT-PnP
        # degenerate — wall-center views measured as the registration
        # breaks at V=50). The offset keeps a corner (two walls) in every
        # view, so no view is ever single-plane.
        la = ang + np.radians(40.0)
        z_axis = np.array([np.sin(la), 0.0, np.cos(la)])
        x_axis = np.cross([0.0, 1.0, 0.0], z_axis)
        x_axis /= np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        R = np.stack([x_axis, y_axis, z_axis])  # world->cam rows
        t = -R @ C
        dirs = rays_cam @ R  # (HW, 3) world-frame ray directions
        best_depth = np.full(height * width, np.inf)
        img = np.zeros(height * width, np.float32)
        for (P0, n, u, vv, (eu, ev)), tex in zip(planes, textures):
            denom = dirs @ n
            with np.errstate(divide="ignore", invalid="ignore"):
                tt = ((P0 - C) @ n) / denom
                tt = np.where(np.isfinite(tt), tt, -1.0)
                hitw = C[None, :] + tt[:, None] * dirs
                a = (hitw - P0) @ u
                b = (hitw - P0) @ vv
            ok = (
                (tt > 0.05) & np.isfinite(tt)
                & (np.abs(a) < eu) & (np.abs(b) < ev)
                & (tt < best_depth)
            )
            n_t = tex.shape[0]
            ta = (a / eu * 0.5 + 0.5) * (n_t - 1)
            tb = (b / ev * 0.5 + 0.5) * (n_t - 1)
            ia = np.clip(ta.astype(np.int64), 0, n_t - 2)
            ib = np.clip(tb.astype(np.int64), 0, n_t - 2)
            fa = np.clip(ta - ia, 0, 1).astype(np.float32)
            fb = np.clip(tb - ib, 0, 1).astype(np.float32)
            val = (
                tex[ib, ia] * (1 - fa) * (1 - fb)
                + tex[ib, ia + 1] * fa * (1 - fb)
                + tex[ib + 1, ia] * (1 - fa) * fb
                + tex[ib + 1, ia + 1] * fa * fb
            )
            img = np.where(ok, val, img)
            best_depth = np.where(ok, tt, best_depth)
        gray[v] = img.reshape(height, width)
        R_all[v] = R
        t_all[v] = t
        C_all[v] = C

    color = np.repeat(gray[..., None], 3, axis=-1)
    images = ImageBatch(
        gray=gray,
        color=color,
        sizes=np.tile(
            np.array([[height, width]], np.int32), (n_views, 1)
        ),
        paths=tuple(f"synth_{v:04d}" for v in range(n_views)),
    )
    intr = Intrinsics(
        K=K.astype(np.float32), dist=np.zeros((5,), np.float32)
    )
    return SynthScene(
        images=images, intrinsics=intr, R=R_all, t=t_all, centers=C_all
    )
