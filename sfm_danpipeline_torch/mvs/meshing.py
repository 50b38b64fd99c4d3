"""Surface meshing: TSDF fusion of depth maps + marching tetrahedra.

Port of sfm_danpipeline_tpu/mvs/meshing.py, which replaces the reference's
meshing stage (`create_mesh`, src/Sfm.cpp:1347-1383: PCL normal estimation
+ Poisson depth-7 reconstruction). Poisson solves a global screened-Poisson
system on an octree, an irregular CPU algorithm; the route to the same
artifact (a watertight-ish surface from the dense reconstruction) is:

 1. TSDF fusion: a regular voxel grid integrates truncated signed distances
    from every view's depth map: batched bilinear gathers + elementwise
    updates on the device, in chunks of voxels.
 2. Marching tetrahedra on the fused grid (host numpy, vectorized, as in
    the reference package): each cube splits into 6 tetrahedra; the 16-case
    sign table is derived programmatically, avoiding the error-prone
    256-entry marching-cubes tables. More triangles than MC, but simple and
    correct.

Divergence note: the reference's Poisson smoothing parameters (depth 7,
pointWeight 4, ...) have no direct analogue; grid resolution plays the role
of `depth` (128^3 ~ Poisson depth 7).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from sfm_danpipeline_torch import require_device
from sfm_danpipeline_torch.ops.interp import bilinear_sample_batch


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray  # (NV, 3) float32
    faces: np.ndarray  # (NF, 3) int32


def fuse_tsdf(
    voxels: torch.Tensor,  # (N, 3) world voxel centers
    depth_maps: torch.Tensor,  # (V, H, W)
    R: torch.Tensor,  # (V, 3, 3) world->cam
    t: torch.Tensor,  # (V, 3)
    K: torch.Tensor,
    cam_valid: torch.Tensor,  # (V,)
    trunc: float,
    chunk: int = 262144,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted TSDF of each voxel. Returns (tsdf (N,), weight (N,)).
    `chunk` bounds the (V, chunk) projection tensors."""
    V, H, W = depth_maps.shape
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    tsdf, wgt = [], []
    for s in range(0, voxels.shape[0], chunk):
        p = voxels[s : s + chunk]
        cam = torch.einsum("vij,nj->vni", R, p) + t[:, None, :]  # (V, n, 3)
        z = cam[..., 2]
        zsafe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        u = cam[..., 0] / zsafe * fx + cx
        w = cam[..., 1] / zsafe * fy + cy
        inside = (u >= 0) & (u <= W - 1) & (w >= 0) & (w <= H - 1) & (z > 0.05)
        d = bilinear_sample_batch(depth_maps, u, w)
        sdf = (d - z) / trunc  # + in front of surface
        ok = inside & (d > 0) & (sdf > -1.0) & cam_valid[:, None]
        wv = ok.to(sdf.dtype)
        wsum = torch.sum(wv, dim=0)
        ssum = torch.sum(torch.clamp(sdf, -1.0, 1.0) * wv, dim=0)
        tsdf.append(ssum / torch.clamp(wsum, min=1e-9))
        wgt.append(wsum)
    return torch.cat(tsdf), torch.cat(wgt)


# Tetrahedra decomposition of a cube (vertex indices 0..7, standard 6-tet).
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    np.int32,
)
# Cube corner offsets (x, y, z).
_CORNERS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [1, 1, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [1, 1, 1],
        [0, 1, 1],
    ],
    np.int32,
)


def _tet_triangles(case: int):
    """Triangles (as vertex-pair edge tuples) for a 4-bit tet sign case.
    Bit i set <=> vertex i is inside (tsdf < 0)."""
    inside = [i for i in range(4) if case & (1 << i)]
    outside = [i for i in range(4) if not case & (1 << i)]
    if len(inside) == 0 or len(inside) == 4:
        return []
    if len(inside) == 1:
        a = inside[0]
        e = [(a, o) for o in outside]
        return [(e[0], e[1], e[2])]
    if len(inside) == 3:
        a = outside[0]
        e = [(i, a) for i in inside]
        # reversed winding vs the 1-inside case
        return [(e[0], e[2], e[1])]
    # two inside, two outside -> quad -> 2 triangles
    a, b = inside
    c, d = outside
    e_ac, e_ad, e_bc, e_bd = (a, c), (a, d), (b, c), (b, d)
    return [(e_ac, e_ad, e_bd), (e_ac, e_bd, e_bc)]


_TET_TABLE = {case: _tet_triangles(case) for case in range(16)}


def marching_tetrahedra(
    tsdf: np.ndarray,  # (G, G, G)
    weight: np.ndarray,
    origin: np.ndarray,
    voxel_size: float,
    min_weight: float = 1.0,
) -> Mesh:
    """Extract the zero level set. Host numpy, vectorized per tet case."""
    G = tsdf.shape[0]
    valid = weight >= min_weight
    # Corner values for all cubes.
    sl = [slice(0, G - 1), slice(1, G)]
    vals = np.stack(
        [tsdf[sl[dx], :, :][:, sl[dy], :][:, :, sl[dz]]
         for dx, dy, dz in _CORNERS],
        axis=-1,
    )  # (G-1, G-1, G-1, 8)
    ok = np.stack(
        [valid[sl[dx], :, :][:, sl[dy], :][:, :, sl[dz]]
         for dx, dy, dz in _CORNERS],
        axis=-1,
    ).all(-1)
    cubes = np.argwhere(ok & (vals.min(-1) < 0) & (vals.max(-1) > 0))
    if len(cubes) == 0:
        return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    cv = vals[cubes[:, 0], cubes[:, 1], cubes[:, 2]]  # (M, 8)
    base = cubes.astype(np.float64)  # cube origin in voxel units

    corner_pos = _CORNERS.astype(np.float64)
    verts_flat = []
    faces_flat = []
    off = 0
    for tet in _TETS:
        tv = cv[:, tet]
        case = ((tv < 0) * (1 << np.arange(4))).sum(-1)
        for c in range(1, 15):
            tris = _TET_TABLE[c]
            rows = np.where(case == c)[0]
            if not tris or len(rows) == 0:
                continue
            for tri in tris:
                pts3 = []
                for (i, j) in tri:
                    vi, vj = tv[rows, i], tv[rows, j]
                    s = vi / (vi - vj + 1e-20)
                    pi = base[rows] + corner_pos[tet[i]]
                    pj = base[rows] + corner_pos[tet[j]]
                    pts3.append(pi + s[:, None] * (pj - pi))
                tri_v = np.stack(pts3, axis=1)  # (R, 3, 3)
                R_ = len(rows)
                verts_flat.append(tri_v.reshape(-1, 3))
                faces_flat.append(
                    np.arange(off, off + 3 * R_).reshape(R_, 3)
                )
                off += 3 * R_
    vertices = (
        np.concatenate(verts_flat) * voxel_size + origin[None, :]
    ).astype(np.float32)
    faces_arr = np.concatenate(faces_flat).astype(np.int32)
    # Weld duplicate vertices (edges shared between tets/cubes).
    keys = np.round(vertices / (voxel_size * 1e-4)).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    welded = np.zeros((len(uniq), 3), np.float64)
    np.add.at(welded, inv, vertices)
    cnt = np.zeros(len(uniq))
    np.add.at(cnt, inv, 1.0)
    welded = (welded / cnt[:, None]).astype(np.float32)
    return Mesh(vertices=welded, faces=inv[faces_arr])


def mesh_from_depth_maps(
    depth_maps: np.ndarray,
    R: np.ndarray,
    t: np.ndarray,
    K: np.ndarray,
    cam_valid: np.ndarray,
    grid: int = 128,
    bounds: Tuple[np.ndarray, np.ndarray] | None = None,
    trunc_voxels: float = 3.0,
    device: str | torch.device = "cuda",
) -> Mesh:
    """End-to-end: TSDF-fuse all depth maps on a grid^3 lattice spanning
    `bounds` (auto from backprojected depths when None), then extract. The
    fusion runs on `device`: the CUDA card unless the caller asks for the
    CPU, raising when there is no card. Inputs and the mesh are host numpy."""
    device = require_device(device)
    V, H, W = depth_maps.shape
    if bounds is None:
        # Backproject a sparse pixel subset to bound the volume.
        pts = []
        for v in range(V):
            if not cam_valid[v]:
                continue
            d = depth_maps[v][::8, ::8]
            ys, xs = np.mgrid[0 : H : 8, 0 : W : 8]
            m = d > 0
            if not m.any():
                continue
            xn = (xs[m] - K[0, 2]) / K[0, 0]
            yn = (ys[m] - K[1, 2]) / K[1, 1]
            cam = np.stack([xn * d[m], yn * d[m], d[m]], -1)
            pts.append((cam - t[v]) @ R[v])
        allp = np.concatenate(pts)
        lo = np.percentile(allp, 2, axis=0)
        hi = np.percentile(allp, 98, axis=0)
        # Pad by a fraction of the LARGEST extent on every axis, so planar
        # scenes (zero thickness along one axis) still get volume to cross.
        pad = 0.05 * (hi - lo) + 0.1 * np.max(hi - lo)
        bounds = (lo - pad, hi + pad)
    lo, hi = bounds
    voxel = float(np.max(hi - lo)) / (grid - 1)
    axes = [np.arange(grid) * voxel + lo[i] for i in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    centers = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    f32 = dict(dtype=torch.float32, device=device)
    tsdf, wgt = fuse_tsdf(
        torch.as_tensor(centers, **f32),
        torch.as_tensor(np.asarray(depth_maps), **f32),
        torch.as_tensor(np.asarray(R), **f32),
        torch.as_tensor(np.asarray(t), **f32),
        torch.as_tensor(np.asarray(K), **f32),
        torch.as_tensor(np.asarray(cam_valid), device=device),
        trunc=trunc_voxels * voxel,
    )
    tsdf = tsdf.cpu().numpy().reshape(grid, grid, grid)
    wgt = wgt.cpu().numpy().reshape(grid, grid, grid)
    return marching_tetrahedra(tsdf, wgt, lo.astype(np.float32), voxel)


def write_obj(path: str, mesh: Mesh) -> None:
    with open(path, "w") as f:
        for v in mesh.vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in mesh.faces:
            f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")
