"""The port's analysis tail (filtering, segmentation, normals, dendrometry)
against the JAX reference on the same numpy clouds, and the reference's own
test cases (tests/test_analysis.py) on the port.

Integer outputs are held equal: neighbour counts and segmentation labels
(kNN indices up to equidistant candidates). Normals: |n . n_ref| > 1 - 1e-4 where the neighbourhood
has a distinct smallest eigenvalue (the reference power-iterates 48 times,
the port calls eigh; a planar patch of noisy points separates them well).
Dendrometry: 1e-6 relative (min / max / norm of float32 values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_danpipeline_tpu.analysis import dendrometry as j_dendro
from sfm_danpipeline_tpu.analysis import filtering as j_filt
from sfm_danpipeline_tpu.analysis import normals as j_normals
from sfm_danpipeline_tpu.analysis import segmentation as j_seg
from sfm_danpipeline_torch.analysis import dendrometry as t_dendro
from sfm_danpipeline_torch.analysis import filtering as t_filt
from sfm_danpipeline_torch.analysis import normals as t_normals
from sfm_danpipeline_torch.analysis import segmentation as t_seg
from torch_testing import one_torch_thread  # noqa: F401


def _tree_cloud(n=3000, seed=0):
    """A trunk, a crown and a ground patch in distinct colours, some invalid."""
    rng = np.random.default_rng(seed)
    k = n // 3
    trunk = np.c_[rng.normal(0, 0.15, (k, 2)), rng.uniform(0, 4, k)]
    crown = rng.normal(0, 0.9, (k, 3)) + [0, 0, 5.5]
    ground = np.c_[rng.uniform(-3, 3, (n - 2 * k, 2)), rng.normal(0, 0.03, n - 2 * k)]
    pts = np.vstack([trunk, crown, ground]).astype(np.float32)
    cols = np.vstack([
        np.tile([0.45, 0.30, 0.15], (k, 1)), np.tile([0.10, 0.55, 0.12], (k, 1)),
        np.tile([0.50, 0.50, 0.50], (n - 2 * k, 1)),
    ]) + rng.normal(0, 0.004, (n, 3))
    valid = np.ones(n, bool)
    valid[::17] = False
    return pts, np.clip(cols, 0, 1).astype(np.float32), valid


@pytest.mark.parametrize("radius", [0.2, 0.5])
def test_neighbor_counts_equal(radius):
    pts, _, valid = _tree_cloud()
    cj = np.asarray(j_filt.neighbor_counts(jnp.asarray(pts), jnp.asarray(valid), radius))
    ct = t_filt.neighbor_counts(torch.tensor(pts), torch.tensor(valid), radius, chunk=700)
    assert ct.dtype == torch.int32
    np.testing.assert_array_equal(ct.numpy(), cj)


def test_filter_masks_equal():
    pts, _, valid = _tree_cloud(seed=1)
    mj = j_filt.passthrough_mask(jnp.asarray(pts), "x", -0.5, 0.83, jnp.asarray(valid))
    mt = t_filt.passthrough_mask(torch.tensor(pts), "x", -0.5, 0.83, torch.tensor(valid))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    oj = j_filt.radius_outlier_mask(jnp.asarray(pts), mj, 0.3, 12)
    ot = t_filt.radius_outlier_mask(torch.tensor(pts), mt, 0.3, 12)
    assert 0 < int(ot.sum()) < int(mt.sum())
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


def test_knn_indices_agree():
    """The same neighbours except where two candidates are equidistant to
    float32 rounding (the |a|^2+|b|^2-2ab distance cancels differently in
    the two matrix products): at least 99.9% of the indices equal, and every
    row's neighbour distances equal to 1e-4."""
    pts, _, valid = _tree_cloud(n=1500, seed=2)
    ij = np.asarray(j_seg.knn_indices(jnp.asarray(pts), jnp.asarray(valid), k=16))
    it = t_seg.knn_indices(torch.tensor(pts), torch.tensor(valid), k=16, chunk=400).numpy()
    assert it.dtype == np.int32
    assert (it == ij).mean() > 0.999
    p64 = pts.astype(np.float64)
    dj = np.linalg.norm(p64[ij] - p64[:, None], axis=-1)
    dt = np.linalg.norm(p64[it] - p64[:, None], axis=-1)
    np.testing.assert_allclose(dt, dj, atol=1e-4)
    assert valid[it].all() and (it != np.arange(1500)[:, None]).all()


@pytest.mark.parametrize("seed,min_cluster", [(0, 100), (3, 600)])
def test_segmentation_labels_equal(seed, min_cluster):
    pts, cols, valid = _tree_cloud(n=3600, seed=seed)
    kw = dict(z_min=-1.0, z_max=14.0, distance=0.6, point_color=6.0, region_color=5.0,
              min_cluster=min_cluster)
    rj = j_seg.segment_cloud(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), **kw)
    rt = t_seg.segment_cloud(torch.tensor(pts), torch.tensor(cols), torch.tensor(valid), **kw)
    assert int(rj.n_clusters) >= 2
    assert int(rt.n_clusters) == int(rj.n_clusters)
    assert rt.labels.dtype == torch.int32
    np.testing.assert_array_equal(rt.labels.numpy(), np.asarray(rj.labels))


def test_normals_agree_up_to_sign_convention():
    rng = np.random.default_rng(4)
    # A tilted plane with 2% noise: a distinct smallest eigenvalue everywhere.
    uv = rng.uniform(-1, 1, (1200, 2))
    pts = (np.c_[uv, 0.3 * uv[:, 0] - 0.2 * uv[:, 1] + 2.0]
           + rng.normal(0, 0.004, (1200, 3))).astype(np.float32)
    valid = np.ones(1200, bool)
    nj = np.asarray(j_normals.estimate_normals(jnp.asarray(pts), jnp.asarray(valid), k=10))
    nt = t_normals.estimate_normals(torch.tensor(pts), torch.tensor(valid), k=10).numpy()
    np.testing.assert_allclose(np.linalg.norm(nt, axis=1), 1.0, atol=1e-5)
    dots = np.abs(np.sum(nj * nt, axis=1))
    # The 48 power iterations have not converged where the two smallest
    # eigenvalues are close; hold the converged rows tightly and all rows
    # to the reference's own test bound.
    assert (dots > 1 - 1e-4).mean() > 0.9, (dots > 1 - 1e-4).mean()
    assert (dots > 0.9).all()
    # Both flip toward the viewpoint (the origin).
    assert (np.sum(nt * -pts, axis=1) >= 0).all()


def test_dendrometry_equal():
    pts, _, valid = _tree_cloud(seed=5)
    rj = j_dendro.estimate(jnp.asarray(pts), jnp.asarray(valid))
    rt = t_dendro.estimate(torch.tensor(pts), torch.tensor(valid))
    assert set(rt) == set(rj)
    for k in rj:
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-6, atol=1e-6, err_msg=k)


# --- the reference's own cases (tests/test_analysis.py) on the port ---


def test_passthrough():
    pts = torch.tensor([[0.0, 0, 0], [0.5, 0, 0], [0.9, 0, 0]])
    assert t_filt.passthrough_mask(pts, "x", 0.003, 0.83).tolist() == [False, True, False]


def test_neighbor_counts_exact():
    pts = np.random.default_rng(0).uniform(0, 1, (300, 3)).astype(np.float32)
    counts = t_filt.neighbor_counts(torch.tensor(pts), torch.ones(300, dtype=torch.bool), 0.2, chunk=64)
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    np.testing.assert_array_equal(counts.numpy(), (d <= 0.2).sum(1) - 1)


def test_radius_outlier_removes_isolated():
    cluster = np.random.default_rng(1).normal(0, 0.02, (200, 3)).astype(np.float32)
    pts = torch.tensor(np.vstack([cluster, np.array([[5, 5, 5], [-5, 5, 0]], np.float32)]))
    m = t_filt.radius_outlier_mask(pts, torch.ones(202, dtype=torch.bool), radius=0.1, min_neighbors=10)
    assert m[:200].all() and not m[200:].any()


def test_two_color_clusters():
    rng = np.random.default_rng(2)
    a = rng.normal(0, 0.5, (400, 3)).astype(np.float32)
    b = rng.normal(0, 0.5, (400, 3)).astype(np.float32) + [4, 0, 0]
    cols = np.zeros((800, 3), np.float32)
    cols[:400] = [1.0, 0.0, 0.0]
    cols[400:] = [0.0, 1.0, 0.0]
    res = t_seg.region_growing_rgb(
        torch.tensor(np.vstack([a, b]).astype(np.float32)), torch.tensor(cols) * 255.0,
        torch.ones(800, dtype=torch.bool),
        distance=1.0, point_color=6.0, region_color=5.0, min_cluster=100,
    )
    assert int(res.n_clusters) == 2
    lab = res.labels.numpy()
    # Isolated stragglers (no kNN edge within `distance`) may drop to -1.
    a_lab = lab[:400][lab[:400] >= 0]
    b_lab = lab[400:][lab[400:] >= 0]
    assert len(a_lab) >= 395 and len(b_lab) >= 395
    assert (a_lab == a_lab[0]).all() and (b_lab == b_lab[0]).all()
    assert a_lab[0] != b_lab[0]


def test_small_clusters_dropped():
    rng = np.random.default_rng(3)
    big = rng.normal(0, 0.3, (500, 3)).astype(np.float32)
    tiny = rng.normal(0, 0.05, (20, 3)).astype(np.float32) + [8, 0, 0]
    res = t_seg.region_growing_rgb(
        torch.tensor(np.vstack([big, tiny]).astype(np.float32)), torch.ones((520, 3)) * 128.0,
        torch.ones(520, dtype=torch.bool), distance=1.0, min_cluster=100,
    )
    assert int(res.n_clusters) == 1
    assert (res.labels.numpy()[500:] == -1).all()


def test_z_passthrough():
    pts = np.zeros((300, 3), np.float32)
    pts[:, 2] = np.linspace(-5, 20, 300)
    pts[:, 0] = np.random.default_rng(4).normal(0, 0.1, 300)
    res = t_seg.segment_cloud(
        torch.tensor(pts), torch.ones((300, 3)) * 0.5, torch.ones(300, dtype=torch.bool),
        z_min=0.0, z_max=14.0, distance=1.0, min_cluster=10,
    )
    z = pts[:, 2]
    assert (res.labels.numpy()[(z < 0) | (z > 14)] == -1).all()


def test_dendrometry_known_box():
    pts = torch.tensor([[0, 0, 0], [1, 0, 0], [0, 2, 0], [0, 0, 3], [1, 2, 3]], dtype=torch.float32)
    rep = t_dendro.estimate(pts, torch.ones(5, dtype=torch.bool))
    np.testing.assert_allclose(rep["total_height"], np.sqrt(1 + 4 + 9), rtol=1e-5)
    assert rep["axis_height"] == 3.0  # z extent is largest
    assert rep["n_points"] == 5


def test_dendrometry_mask_respected():
    pts = torch.tensor([[0, 0, 0], [0, 0, 100]], dtype=torch.float32)
    rep = t_dendro.estimate(pts, torch.tensor([True, False]))
    assert rep["total_height"] == 0.0


def test_plane_normals():
    xy = np.random.default_rng(5).uniform(-1, 1, (500, 2)).astype(np.float32)
    pts = np.concatenate([xy, np.full((500, 1), 2.0, np.float32)], -1)
    n = t_normals.estimate_normals(
        torch.tensor(pts), torch.ones(500, dtype=torch.bool), viewpoint=torch.zeros(3)
    ).numpy()
    # Normal of the z=2 plane is +-z; flipped toward the origin -> -z.
    assert (np.abs(n[:, 2]) > 0.99).mean() > 0.97
    assert (np.abs(n[:, 2]) > 0.9).all()
    assert (n[:, 2] < 0).all()
