"""The benchmark's scene: a textured courtyard with exact ground truth.

A frozen copy of `make_courtyard_scene` and `_texture` from
sfm_danpipeline_torch/utils/synthscene.py (itself a copy of
sfm_danpipeline_tpu/utils/synthscene.py), kept here so that later changes to
the program cannot move the yardstick. Three changes: the per-view ray
casting runs as torch float64 ops on a chosen device (a card renders a
10-view set in well under a second; numpy takes about 0.4 s a view), the
focal length and principal point are the caller's (the original fixes
f = 520 px at the image's center), and the arc may start further along the
ring (the original's first camera sits at 0 degrees).

Scene: a 20 x 12 x 20 room (walls at x, z = +-10, floor and ceiling at
y = -+6) with multi-scale noise textures, and `n_views` cameras on a
radius-4 ring (an arc when `ring_fraction` < 1) looking outward with a
40-degree yaw offset, so every view sees a corner. The room is convex and
every camera is inside it, so nothing is occluded: every pixel sees the
nearest plane its ray hits. Only the textures depend on `seed`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

FOCAL = 520.0
ROOM_HALF = 10.0
WALL_Y = 6.0
RING_RADIUS = 4.0


def texture(rng: np.random.Generator, n: int = 1024) -> np.ndarray:
    """Multi-scale smoothed noise in [0, 1] (synthscene._texture)."""
    tex = np.zeros((n, n), np.float32)
    for scale, amp in ((8, 0.5), (32, 0.9), (128, 1.3)):
        coarse = rng.uniform(-1.0, 1.0, (scale, scale)).astype(np.float32)
        idx = np.linspace(0, scale - 1, n)
        i0 = np.clip(idx.astype(np.int64), 0, scale - 2)
        f = (idx - i0).astype(np.float32)
        rows = coarse[i0] * (1 - f[:, None]) + coarse[i0 + 1] * f[:, None]
        tex += amp * (rows[:, i0] * (1 - f[None, :]) + rows[:, i0 + 1] * f[None, :])
    tex -= tex.min()
    tex /= max(tex.max(), 1e-6)
    return tex


def planes():
    """(origin, unit normal, u axis, v axis, (half extent u, half extent v))
    of the four walls, the floor and the ceiling."""
    h, wy = ROOM_HALF, WALL_Y
    a = np.array
    return [
        (a([h, 0.0, 0.0]), a([-1.0, 0, 0]), a([0, 0, 1.0]), a([0, 1.0, 0]), (h, wy)),
        (a([-h, 0.0, 0.0]), a([1.0, 0, 0]), a([0, 0, -1.0]), a([0, 1.0, 0]), (h, wy)),
        (a([0.0, 0.0, h]), a([0, 0, -1.0]), a([-1.0, 0, 0]), a([0, 1.0, 0]), (h, wy)),
        (a([0.0, 0.0, -h]), a([0, 0, 1.0]), a([1.0, 0, 0]), a([0, 1.0, 0]), (h, wy)),
        (a([0.0, -wy, 0.0]), a([0, 1.0, 0]), a([1.0, 0, 0]), a([0, 0, 1.0]), (h, h)),
        (a([0.0, wy, 0.0]), a([0, -1.0, 0]), a([1.0, 0, 0]), a([0, 0, -1.0]), (h, h)),
    ]


def ring_cameras(n_views: int, ring_fraction: float, arc_start_deg: float = 0.0):
    """Ground-truth world->camera rotations (V, 3, 3), translations (V, 3)
    and centers (V, 3); the first camera sits `arc_start_deg` along the
    ring."""
    R_all = np.zeros((n_views, 3, 3))
    t_all = np.zeros((n_views, 3))
    C_all = np.zeros((n_views, 3))
    for v in range(n_views):
        ang = np.radians(arc_start_deg) + ring_fraction * 2.0 * np.pi * v / n_views
        C = RING_RADIUS * np.array([np.sin(ang), 0.0, np.cos(ang)])
        C[1] = 0.4 * np.sin(3.0 * ang)
        la = ang + np.radians(40.0)
        z_axis = np.array([np.sin(la), 0.0, np.cos(la)])
        x_axis = np.cross([0.0, 1.0, 0.0], z_axis)
        x_axis /= np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        R = np.stack([x_axis, y_axis, z_axis])
        R_all[v], t_all[v], C_all[v] = R, -R @ C, C
    return R_all, t_all, C_all


def cast(C: torch.Tensor, dirs: torch.Tensor):
    """First hit of the rays `C + s * dirs` (dirs (N, 3) float64, `s` the
    z-depth when dirs come from camera rays with unit z) with the room:
    (depth (N,), plane index (N,), in-plane coordinates a, b (N,)). Every ray
    from inside the room hits it."""
    f64 = dict(dtype=torch.float64, device=dirs.device)
    depth = torch.full(dirs.shape[:1], float("inf"), **f64)
    plane = torch.zeros(dirs.shape[:1], dtype=torch.long, device=dirs.device)
    coord_a = torch.zeros_like(depth)
    coord_b = torch.zeros_like(depth)
    for k, (P0, n, u, vv, (eu, ev)) in enumerate(planes()):
        P0, n, u, vv = (torch.as_tensor(x, **f64) for x in (P0, n, u, vv))
        tt = ((P0 - C) @ n) / (dirs @ n)
        tt = torch.where(torch.isfinite(tt), tt, torch.full_like(tt, -1.0))
        hit = C + tt[:, None] * dirs
        a = (hit - P0) @ u
        b = (hit - P0) @ vv
        ok = (tt > 0.05) & (a.abs() < eu) & (b.abs() < ev) & (tt < depth)
        depth = torch.where(ok, tt, depth)
        plane = torch.where(ok, k, plane)
        coord_a = torch.where(ok, a / eu, coord_a)
        coord_b = torch.where(ok, b / ev, coord_b)
    return depth, plane, coord_a, coord_b


def pixel_rays(K: np.ndarray, R: np.ndarray, xy, device="cpu") -> torch.Tensor:
    """World-frame directions (N, 3) float64 of the rays through pixels
    `xy` (N, 2) of a camera with intrinsics K and world->camera rotation R;
    their z component in the camera frame is 1, so `cast` returns z-depth."""
    f64 = dict(dtype=torch.float64, device=device)
    xy = torch.as_tensor(xy, **f64)
    rays = torch.stack(
        [(xy[:, 0] - K[0, 2]) / K[0, 0], (xy[:, 1] - K[1, 2]) / K[1, 1], torch.ones_like(xy[:, 0])], -1
    )
    return rays @ torch.as_tensor(R, **f64)


@dataclasses.dataclass
class Scene:
    gray: np.ndarray  # (V, H, W) float32 in [0, 1]
    K: np.ndarray  # (3, 3) float64
    R: np.ndarray  # (V, 3, 3) world->camera
    t: np.ndarray  # (V, 3)
    centers: np.ndarray  # (V, 3)

    @property
    def n_views(self) -> int:
        return self.gray.shape[0]

    def world_points(self, view: int, xy: np.ndarray) -> np.ndarray:
        """The exact world points (N, 3) seen at pixels `xy` (N, 2) of a view
        (a ray cast)."""
        dirs = pixel_rays(self.K, self.R[view], xy)
        C = torch.as_tensor(self.centers[view], dtype=torch.float64)
        depth = cast(C, dirs)[0]
        return (C + depth[:, None] * dirs).numpy()


def render(
    n_views: int, ring_fraction: float, seed: int, height: int = 480, width: int = 640,
    focal: float = FOCAL, cx: float | None = None, cy: float | None = None,
    arc_start_deg: float = 0.0, device: str | torch.device = "cpu",
) -> Scene:
    """Render the courtyard seen from `n_views` ring cameras with focal
    length `focal` and principal point (cx, cy) in pixels (the image's
    center where not given); the textures are drawn from `seed` (any
    non-negative integer)."""
    rng = np.random.default_rng(seed)
    cx = width / 2.0 if cx is None else cx
    cy = height / 2.0 if cy is None else cy
    K = np.array([[focal, 0, cx], [0, focal, cy], [0, 0, 1.0]], np.float64)
    textures = torch.as_tensor(np.stack([texture(rng) for _ in planes()]), device=device)
    R_all, t_all, C_all = ring_cameras(n_views, ring_fraction, arc_start_deg)
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float64), torch.arange(width, dtype=torch.float64),
        indexing="ij",
    )
    xy = torch.stack([xs, ys], -1).reshape(-1, 2)
    n_t = textures.shape[-1]
    gray = torch.zeros((n_views, height * width), dtype=torch.float32, device=device)
    for v in range(n_views):
        C = torch.as_tensor(C_all[v], dtype=torch.float64, device=device)
        _, plane, a, b = cast(C, pixel_rays(K, R_all[v], xy, device))
        # Bilinear texture lookup in float32, as synthscene does it.
        ta = (a * 0.5 + 0.5) * (n_t - 1)
        tb = (b * 0.5 + 0.5) * (n_t - 1)
        ia = ta.clamp(0, n_t - 2).long()
        ib = tb.clamp(0, n_t - 2).long()
        fa = (ta - ia).clamp(0, 1).float()
        fb = (tb - ib).clamp(0, 1).float()
        gray[v] = (
            textures[plane, ib, ia] * (1 - fa) * (1 - fb)
            + textures[plane, ib, ia + 1] * fa * (1 - fb)
            + textures[plane, ib + 1, ia] * (1 - fa) * fb
            + textures[plane, ib + 1, ia + 1] * fa * fb
        )
    return Scene(
        gray=gray.reshape(n_views, height, width).cpu().numpy(),
        K=K, R=R_all, t=t_all, centers=C_all,
    )


def surface_distance(X: np.ndarray) -> np.ndarray:
    """Distance of world points (N, 3) to the room's surface (the box
    |x|, |z| <= 10, |y| <= 6), inside or outside it."""
    half = np.array([ROOM_HALF, WALL_Y, ROOM_HALF])
    q = np.abs(X) - half
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = -np.max(q, axis=-1)
    return np.where(np.any(q > 0, axis=-1), outside, inside)
