"""Parity of the port's dense stage (sfm_danpipeline_torch.mvs and
ops/projection.undistort_image) with the JAX reference.

The cases of tests/test_mvs.py run through both packages on the same
rendered planes: depth maps must be valid on the same pixels (>= 99%) and
agree within 1e-3 relative where both are valid, homographies within 1e-5
relative. The source-consensus median is checked on its own with an even
number of qualifying sources (numpy's nanmedian averages the two middle
values, torch.nanmedian would return the lower one). `densify` then runs
through both packages on the reference's V=6 reconstruction (240x320,
level 1) and on the same arc rendered at 480x640 with its ground-truth
cameras (level 2): depth validity agrees on >= 99% of pixels, depths
within 1e-3 relative where both are valid, `n_dense_points` within 2%.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_danpipeline_tpu.mvs import fusion as j_fus
from sfm_danpipeline_tpu.mvs import planesweep as j_ps
from sfm_danpipeline_tpu.mvs import rectsweep as j_rs
from sfm_danpipeline_tpu.ops import projection as j_proj
from sfm_danpipeline_torch import interop
from sfm_danpipeline_torch.mvs import fusion as t_fus
from sfm_danpipeline_torch.mvs import planesweep as t_ps
from sfm_danpipeline_torch.mvs import rectsweep as t_rs
from sfm_danpipeline_torch.ops import projection as t_proj
from test_mvs import _render_plane, _texture
from torch_v6_reference import reference_v6
from torch_testing import one_torch_thread  # noqa: F401


def _t(a):
    return torch.tensor(np.asarray(a))


def _assert_depth_agrees(dt, dj, frac=0.99, rtol=1e-3):
    dt, dj = np.asarray(dt), np.asarray(dj)
    same = np.mean((dt > 0) == (dj > 0))
    assert same >= frac, same
    both = (dt > 0) & (dj > 0)
    if both.any():
        rel = np.abs(dt[both] - dj[both]) / dj[both]
        assert rel.max() <= rtol, rel.max()


def test_plane_homography_matches():
    K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]], np.float32)
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.3, 0.0, 0.0], np.float32)
    Hj = j_ps.plane_homography(jnp.asarray(K), jnp.asarray(R), jnp.asarray(t), 2.0)
    Ht = t_ps.plane_homography(_t(K), _t(R), _t(t), 2.0)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("w", [7, 4])
def test_window_mean_matches(w):
    x = np.random.default_rng(0).normal(size=(3, 20, 17)).astype(np.float32)
    np.testing.assert_allclose(
        t_ps._window_mean(_t(x), w).numpy(), np.asarray(j_ps._window_mean(jnp.asarray(x), w)),
        rtol=1e-5, atol=1e-6,
    )


def _plane_pair(seed, depth_gt, rot_deg, two_planes=False):
    h, w = 96, 128
    K = np.array([[120.0, 0, w / 2], [0, 120.0, h / 2], [0, 0, 1]])
    tex = _texture(512, 512, seed=seed)
    a = np.radians(rot_deg)
    R2 = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t2 = np.array([0.25, 0.03, 0.0])
    ref = _render_plane(K, np.eye(3), np.zeros(3), tex, 60.0, depth_gt, h, w)
    src = _render_plane(K, R2, t2, tex, 60.0, depth_gt, h, w)
    if two_planes:
        far = _render_plane(K, np.eye(3), np.zeros(3), tex, 30.0, 2 * depth_gt, h, w)
        far2 = _render_plane(K, R2, t2, tex, 30.0, 2 * depth_gt, h, w)
        mask = np.zeros((h, w), bool)
        mask[:, : w // 2] = True
        ref, src = np.where(mask, ref, far), np.where(mask, src, far2)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(K), f32(ref), f32(src)[None], f32(R2)[None], f32(t2)[None]


@pytest.mark.parametrize("two_planes", [False, True])
def test_sweep_depth_map_matches(two_planes):
    K, ref, src, R2, t2 = _plane_pair(1, 3.0, 0.0, two_planes)
    depths = np.linspace(1.5, 6.0 if not two_planes else 8.0, 64).astype(np.float32)
    valid = np.ones(1, bool)
    dj = j_ps.sweep_depth_map(*(jnp.asarray(a) for a in (ref, src, K, R2, t2, valid, depths)), min_score=0.7)
    dt = t_ps.sweep_depth_map(*(_t(a) for a in (ref, src, K, R2, t2, valid, depths)), min_score=0.7)
    _assert_depth_agrees(dt.depth.numpy(), dj.depth)
    interior = dt.depth.numpy()[10:-10, 10:-10]
    assert (interior > 0).mean() > 0.9


def test_depth_hypotheses_match():
    z = np.concatenate([np.full(50, -1.0), np.linspace(2, 8, 100)]).astype(np.float32)
    np.testing.assert_allclose(
        t_ps.make_depth_hypotheses(_t(z), 32).numpy(),
        np.asarray(j_ps.make_depth_hypotheses(jnp.asarray(z), 32)), rtol=1e-5,
    )


@pytest.mark.parametrize("case", ["rotated_source", "two_planes"])
def test_rect_sweep_depth_map_matches(case):
    K, ref, src, R2, t2 = _plane_pair(3, 3.0, 4.0, two_planes=case == "two_planes")
    valid = np.ones(1, bool)
    z_lo, z_hi = np.float32(1.5), np.float32(8.0)
    dj = j_rs.rect_sweep_depth_map(
        *(jnp.asarray(a) for a in (ref, src, K, R2, t2, valid, z_lo, z_hi)), min_score=0.7, n_depths=96
    )
    dt = t_rs.rect_sweep_depth_map(
        *(_t(a) for a in (ref, src, K, R2, t2, valid)), z_lo, z_hi, min_score=0.7, n_depths=96
    )
    _assert_depth_agrees(dt.depth.numpy(), dj.depth)
    if case == "rotated_source":
        interior = dt.depth.numpy()[12:-12, 12:-12]
        assert (interior > 0).mean() > 0.8
        assert abs(np.median(interior[interior > 0]) - 3.0) < 0.1


def test_rect_sweep_multi_source_consensus_matches():
    h, w = 96, 128
    K = np.array([[120.0, 0, w / 2], [0, 120.0, h / 2], [0, 0, 1]])
    tex = _texture(512, 512, seed=7)
    ref = _render_plane(K, np.eye(3), np.zeros(3), tex, 60.0, 3.2, h, w)
    ts = [np.array([dx, dy, 0.0]) for dx, dy in ((0.25, 0.0), (-0.22, 0.04), (0.1, -0.2), (0.0, 0.23))]
    srcs = np.stack([_render_plane(K, np.eye(3), t, tex, 60.0, 3.2, h, w) for t in ts])
    args = (ref, srcs, K, np.stack([np.eye(3)] * 4), np.stack(ts), np.ones(4, bool))
    args = tuple(np.asarray(a, np.float32) if a.dtype != bool else a for a in args)
    dj = j_rs.rect_sweep_depth_map(*(jnp.asarray(a) for a in args), jnp.float32(1.5), jnp.float32(6.0), n_depths=96)
    dt = t_rs.rect_sweep_depth_map(*(_t(a) for a in args), 1.5, 6.0, n_depths=96)
    _assert_depth_agrees(dt.depth.numpy(), dj.depth)
    interior = dt.depth.numpy()[12:-12, 12:-12]
    assert abs(np.median(interior[interior > 0]) - 3.2) < 0.1


def test_consensus_median_even_count():
    """Four sources, some pixels with 2 or 4 qualifying depths: the median
    is the mean of the middle two, as jnp.nanmedian computes it."""
    rng = np.random.default_rng(0)
    x = rng.uniform(1.0, 2.0, size=(4, 5, 6)).astype(np.float32)
    valid = rng.uniform(size=(4, 5, 6)) > 0.4
    valid[:, 0, 0] = [True, True, False, False]
    valid[:, 0, 1] = True
    valid[:, 0, 2] = False
    want = np.nan_to_num(np.asarray(jnp.nanmedian(jnp.where(jnp.asarray(valid), jnp.asarray(x), jnp.nan), axis=0)))
    got = t_rs.nanmedian_mean_middle(_t(x), _t(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0, 0] == np.float32(0.5) * (x[0, 0, 0] + x[1, 0, 0])
    assert got[0, 2] == 0.0


def test_fuse_view_matches():
    h, w, V = 32, 40, 3
    K = np.array([[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1]], np.float32)
    depths = np.full((V, h, w), 2.0, np.float32)
    depths[2, :10, :10] = 0.5
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (V, 3, 3)).copy()
    t = np.array([[0, 0, 0], [0.05, 0, 0], [-0.05, 0, 0]], np.float32)
    colors = np.random.default_rng(1).uniform(size=(V, h, w, 3)).astype(np.float32)
    cv = np.ones(V, bool)
    fj = j_fus.fuse_view(jnp.asarray(0), *(jnp.asarray(a) for a in (depths, colors, R, t, K, cv)),
                         min_consistent=2, depth_consistency=0.02)
    ft = t_fus.fuse_view(0, *(_t(a) for a in (depths, colors, R, t, K, cv)),
                         min_consistent=2, depth_consistency=0.02)
    np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
    np.testing.assert_allclose(ft.points.numpy(), np.asarray(fj.points), atol=1e-6)
    np.testing.assert_array_equal(ft.colors.numpy(), np.asarray(fj.colors))
    assert ft.valid.numpy().reshape(h, w)[12:-4, 12:-4].mean() > 0.9


def test_voxel_downsample_matches():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, size=(500, 3)).astype(np.float32)
    pts[100:200] = pts[:100] + 1e-4
    cols = rng.uniform(size=(500, 3)).astype(np.float32)
    pj, cj = j_fus.voxel_downsample(pts, cols, 0.05)
    pt, ct = t_fus.voxel_downsample(pts, cols, 0.05)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(ct, cj)


@pytest.mark.parametrize("channels", [0, 3])
def test_undistort_image_matches(channels):
    rng = np.random.default_rng(3)
    shape = (40, 52) + ((channels,) if channels else ())
    img = rng.uniform(size=shape).astype(np.float32)
    K = np.array([[60.0, 0, 26.5], [0, 61.0, 19.0], [0, 0, 1]], np.float32)
    dist = np.array([0.12, -0.05, 0.002, -0.001, 0.01], np.float32)
    want = np.asarray(j_proj.undistort_image(jnp.asarray(img), jnp.asarray(K), jnp.asarray(dist)))
    got = t_proj.undistort_image(_t(img), _t(K), _t(dist)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _densify_both(images, intrinsics, state_np, config_kw):
    from sfm_danpipeline_tpu.config import MVSConfig as JMVSConfig
    from sfm_danpipeline_tpu.mvs.pipeline import densify as j_densify
    from sfm_danpipeline_tpu.pipeline.tracks import ReconstructionState as JState

    from sfm_danpipeline_torch.config import MVSConfig
    from sfm_danpipeline_torch.mvs.pipeline import densify

    js = JState(**{k: jnp.asarray(v) for k, v in state_np.items()})
    dj = j_densify(images, intrinsics, js, JMVSConfig(**config_kw))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        dt = densify(images, intrinsics, interop.state_from_numpy(state_np), MVSConfig(**config_kw))
    finally:
        torch.set_num_threads(threads)
    assert set(dt.metrics) == set(dj.metrics)
    assert dt.depth_maps.shape == dj.depth_maps.shape
    _assert_depth_agrees(dt.depth_maps, dj.depth_maps)
    nj, nt = dj.metrics["n_dense_points"], dt.metrics["n_dense_points"]
    assert abs(nt - nj) <= 0.02 * nj, (nt, nj)
    assert abs(dt.metrics["depth_coverage"] - dj.metrics["depth_coverage"]) <= 0.01
    assert abs(dt.metrics["sparse_depth_med_rel_err"] - dj.metrics["sparse_depth_med_rel_err"]) <= 1e-3
    return dj, dt


def test_densify_matches_on_reference_state():
    """The reference's V=6 reconstruction at 240x320, level 1. Its 34-deg
    field of view is narrower than the 35-50 deg rectifying rotations of
    this arc (the cameras look 40 deg off the ring's normal), so no pair
    rectifies inside the image and both packages return the same empty
    result; the next test runs the same arc where the sweep has pixels."""
    ref = reference_v6()
    dj, dt = _densify_both(ref.scene.images, ref.scene.intrinsics, ref.state, {})
    assert dt.depth_maps.shape == (6, 120, 160)
    assert dj.metrics["n_dense_points"] == dt.metrics["n_dense_points"] == 0


def _ground_truth_state(scene, n_per_view=80, seed=0):
    """A sparse state from the scene's own cameras: points cast from random
    pixels of every view onto the room's walls (a box seen from inside, so
    nothing is occluded), tracked in every view they project into."""
    from sfm_danpipeline_torch.ops.lie import log_so3

    rng = np.random.default_rng(seed)
    V = scene.images.n_images
    Hh, Ww = scene.images.shape
    K = np.asarray(scene.intrinsics.K, np.float64)
    bounds = np.array([10.0, 6.0, 10.0])
    pts = []
    for v in range(V):
        px = rng.uniform([0, 0], [Ww - 1, Hh - 1], size=(n_per_view, 2))
        d = np.c_[(px - K[:2, 2]) / K[0, 0], np.ones(n_per_view)] @ scene.R[v]
        C = scene.centers[v]
        with np.errstate(divide="ignore"):
            tt = np.where(d > 0, (bounds - C) / d, np.where(d < 0, (-bounds - C) / d, np.inf))
        pts.append(C + tt.min(1, keepdims=True) * d)
    X = np.concatenate(pts)
    cam = np.einsum("vij,pj->pvi", scene.R, X) + scene.t[None]
    uv = cam[..., :2] / cam[..., 2:] * K[0, 0] + K[:2, 2]
    seen = (cam[..., 2] > 0.1) & (uv >= 0).all(-1) & (uv[..., 0] < Ww) & (uv[..., 1] < Hh)
    P = len(X)
    return dict(
        points_xyz=X.astype(np.float32), points_rgb=np.zeros((P, 3), np.float32),
        points_valid=seen.sum(1) >= 2, track_feat=np.where(seen, 0, -1).astype(np.int32),
        feat_to_point=np.full((V, 8), -1, np.int32),
        cameras=np.concatenate(
            [log_so3(torch.tensor(scene.R, dtype=torch.float32)).numpy(), scene.t], -1
        ).astype(np.float32),
        camera_valid=np.ones(V, bool), focal=np.float32(K[0, 0]), n_points=np.int32(P),
    )


def test_densify_matches_on_ground_truth_arc():
    """The same V=6 arc rendered at 480x640 (63-deg field of view), with
    the ground-truth cameras and wall points as the sparse state, swept at
    level 2 (120x160 depth maps, the working size of the previous test)."""
    from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene

    scene = make_courtyard_scene(n_views=6, ring_fraction=0.12, seed=0)
    dj, dt = _densify_both(scene.images, scene.intrinsics, _ground_truth_state(scene), {"level": 2})
    assert dt.depth_maps.shape == (6, 120, 160)
    assert dt.metrics["n_dense_points"] > 1000, dt.metrics
    assert dt.metrics["depth_coverage"] > 0.2, dt.metrics
    assert dt.metrics["sparse_depth_med_rel_err"] < 0.02, dt.metrics
