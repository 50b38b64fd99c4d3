"""The port's meshing (sfm_danpipeline_torch.mvs.meshing) against the JAX
reference, and the reference's own cases (tests/test_meshing.py) on the
port.

`fuse_tsdf` on the same depth maps, cameras and a 24^3 voxel block: TSDF
and weights within 1e-5 (float32 projection + bilinear sample; the weights
are small integers and must be equal). `marching_tetrahedra` is host numpy
in both packages: identical face and vertex counts on the fused grid, and
the end-to-end mesh from depth maps has the reference's face count.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_danpipeline_tpu.mvs import meshing as j_mesh
from sfm_danpipeline_torch.mvs import meshing as t_mesh
from torch_testing import one_torch_thread  # noqa: F401


def _two_view_wall(H=48, W=64, V=3):
    """Cameras along x looking at a slanted wall: depth varies per pixel."""
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (V, 3, 3)).copy()
    t = np.array([[-0.15 * v, 0, 0] for v in range(V)], np.float32)
    depth = np.stack([
        2.0 + 0.004 * (xs - W / 2) + 0.002 * (ys - H / 2) + 0.01 * v for v in range(V)
    ]).astype(np.float32)
    depth[0, :4] = 0.0  # unobserved rows
    return depth, R, t, K, np.array([True] * (V - 1) + [False])


def test_fuse_tsdf_agrees():
    depth, R, t, K, cam_valid = _two_view_wall()
    ax = np.linspace(-0.6, 0.6, 24).astype(np.float32)
    gx, gy, gz = np.meshgrid(ax, ax, ax + 2.0, indexing="ij")
    vox = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    tj, wj = j_mesh.fuse_tsdf(
        *(jnp.asarray(a) for a in (vox, depth, R, t, K, cam_valid)), trunc=0.15, chunk=4096
    )
    tt, wt = t_mesh.fuse_tsdf(
        *(torch.tensor(a) for a in (vox, depth, R, t, K, cam_valid)), trunc=0.15, chunk=5000
    )
    assert float(np.asarray(wj).max()) == 2.0  # the invalid camera adds nothing
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-5)
    mj = j_mesh.marching_tetrahedra(
        np.asarray(tj).reshape(24, 24, 24), np.asarray(wj).reshape(24, 24, 24),
        np.array([-0.6, -0.6, 1.4], np.float32), float(ax[1] - ax[0]),
    )
    mt = t_mesh.marching_tetrahedra(
        tt.numpy().reshape(24, 24, 24), wt.numpy().reshape(24, 24, 24),
        np.array([-0.6, -0.6, 1.4], np.float32), float(ax[1] - ax[0]),
    )
    assert len(mt.faces) == len(mj.faces) > 100
    assert len(mt.vertices) == len(mj.vertices)


def test_mesh_from_depth_maps_has_reference_face_count(tmp_path):
    depth, R, t, K, cam_valid = _two_view_wall()
    mj = j_mesh.mesh_from_depth_maps(depth, R, t, K, cam_valid, grid=32)
    mt = t_mesh.mesh_from_depth_maps(depth, R, t, K, cam_valid, grid=32, device="cpu")
    assert len(mt.faces) == len(mj.faces) > 100
    np.testing.assert_allclose(
        np.sort(mt.vertices, axis=0), np.sort(mj.vertices, axis=0), atol=1e-4
    )
    t_mesh.write_obj(str(tmp_path / "m.obj"), mt)
    lines = (tmp_path / "m.obj").read_text().splitlines()
    assert sum(l.startswith("v ") for l in lines) == len(mt.vertices)
    assert sum(l.startswith("f ") for l in lines) == len(mt.faces)


# --- the reference's own cases (tests/test_meshing.py) on the port ---


def _sphere_tsdf(grid=48, radius=0.3):
    ax = np.linspace(-0.5, 0.5, grid)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    return (np.sqrt(gx**2 + gy**2 + gz**2) - radius).astype(np.float32), ax[1] - ax[0]


def test_sphere_surface():
    tsdf, voxel = _sphere_tsdf()
    mesh = t_mesh.marching_tetrahedra(
        tsdf, np.ones_like(tsdf), np.array([-0.5, -0.5, -0.5], np.float32), voxel
    )
    assert len(mesh.vertices) > 500 and len(mesh.faces) > 1000
    r = np.linalg.norm(mesh.vertices, axis=1)
    np.testing.assert_allclose(r.mean(), 0.3, atol=0.01)
    assert r.std() < 0.01
    assert 0 <= mesh.faces.min() and mesh.faces.max() < len(mesh.vertices)


def test_empty_when_no_crossing():
    tsdf = np.ones((8, 8, 8), np.float32)
    mesh = t_mesh.marching_tetrahedra(tsdf, np.ones_like(tsdf), np.zeros(3, np.float32), 0.1)
    assert len(mesh.faces) == 0


def test_low_weight_excluded():
    tsdf, voxel = _sphere_tsdf(grid=24)
    mesh = t_mesh.marching_tetrahedra(tsdf, np.zeros_like(tsdf), np.zeros(3, np.float32), voxel)
    assert len(mesh.faces) == 0


def test_plane_depth_map_fusion():
    # One camera at the origin looking at the plane z=2: the TSDF along the
    # ray crosses zero at z=2.
    H, W = 48, 64
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    zs = np.linspace(1.0, 3.0, 41).astype(np.float32)
    vox = np.stack([np.zeros_like(zs), np.zeros_like(zs), zs], -1)
    tsdf, wgt = t_mesh.fuse_tsdf(
        torch.tensor(vox), torch.full((1, H, W), 2.0), torch.eye(3)[None], torch.zeros((1, 3)),
        torch.tensor(K), torch.ones(1, dtype=torch.bool), trunc=0.3,
    )
    tsdf, wgt = tsdf.numpy(), wgt.numpy()
    assert (wgt[(zs > 1.1) & (zs < 2.25)] > 0).all()
    # Positive in front (z < 2), negative just behind.
    assert tsdf[zs == 1.9][0] > 0
    assert tsdf[np.isclose(zs, 2.1)][0] < 0
    band = (zs > 1.5) & (zs < 2.5)
    assert abs(zs[band][np.argmin(np.abs(tsdf[band]))] - 2.0) < 0.06


def test_end_to_end_plane_mesh():
    H, W = 48, 64
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    depth = np.full((2, H, W), 2.0, np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3)).copy()
    t = np.array([[0, 0, 0], [0.1, 0, 0]], np.float32)
    mesh = t_mesh.mesh_from_depth_maps(depth, R, t, K, np.ones(2, bool), grid=48, device="cpu")
    assert len(mesh.faces) > 100
    np.testing.assert_allclose(mesh.vertices[:, 2].mean(), 2.0, atol=0.05)


def test_meshing_runs_on_the_card_unless_asked_for_the_cpu():
    """`mesh_from_depth_maps` fuses on the CUDA card by default; with none
    present it raises rather than fusing on the CPU, which only
    `device="cpu"` selects."""
    H, W = 24, 32
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    args = (
        np.full((1, H, W), 2.0, np.float32), np.eye(3, dtype=np.float32)[None],
        np.zeros((1, 3), np.float32), K, np.ones(1, bool),
    )
    if torch.cuda.is_available():
        assert len(t_mesh.mesh_from_depth_maps(*args, grid=16).faces) > 0
    else:
        with pytest.raises(RuntimeError, match="CUDA card"):
            t_mesh.mesh_from_depth_maps(*args, grid=16)
