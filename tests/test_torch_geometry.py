"""Parity of the port's geometry leaves (sfm_danpipeline_torch.ops.lie,
projection, interp, triangulation) with the JAX reference, on the same
numpy inputs.

Tolerance: rtol 1e-5 (atol 1e-6) — both sides are float32 and evaluate the
same closed forms; only the summation order of small matmuls differs. The
one exception is the triangulated point itself (rtol 1e-4): the DLT is
solved through its 3x3 normal equations, which square the system's
condition number, so last-bit differences in M^T M reach ~1.5e-5 relative.
"""
import jax.numpy as jnp
import numpy as np
import torch

from sfm_danpipeline_tpu.ops import interp as j_interp
from sfm_danpipeline_tpu.ops import lie as j_lie
from sfm_danpipeline_tpu.ops import projection as j_proj
from sfm_danpipeline_tpu.ops import triangulation as j_tri
from sfm_danpipeline_torch.ops import interp as t_interp
from sfm_danpipeline_torch.ops import lie as t_lie
from sfm_danpipeline_torch.ops import projection as t_proj
from sfm_danpipeline_torch.ops import triangulation as t_tri
from torch_testing import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(t.detach().cpu().numpy()), np.asarray(j), rtol=rtol, atol=atol
    )


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def test_lie_maps_match():
    rng = np.random.default_rng(0)
    w = _rand(rng, 64, 3)
    w[:8] *= 1e-5  # Taylor branch
    p = _rand(rng, 64, 3)
    _close(j_lie.hat(jnp.asarray(w)), t_lie.hat(torch.tensor(w)))
    R_j = j_lie.exp_so3(jnp.asarray(w))
    _close(R_j, t_lie.exp_so3(torch.tensor(w)))
    R = np.asarray(R_j)
    _close(j_lie.log_so3(jnp.asarray(R)), t_lie.log_so3(torch.tensor(R)), atol=1e-5)
    _close(
        j_lie.rotate_point(jnp.asarray(w), jnp.asarray(p)),
        t_lie.rotate_point(torch.tensor(w), torch.tensor(p)),
    )


def test_projection_and_undistortion_match():
    rng = np.random.default_rng(1)
    X = _rand(rng, 100, 3) + np.array([0, 0, 5], np.float32)
    R = np.asarray(j_lie.exp_so3(jnp.asarray(_rand(rng, 3, scale=0.1))))
    t = _rand(rng, 3, scale=0.2)
    K = np.array([[800, 0, 320], [0, 780, 240], [0, 0, 1]], np.float32)
    dist = np.array([-0.2, 0.05, 1e-3, -1e-3, 0.01], np.float32)
    px = rng.uniform(0, 640, (100, 2)).astype(np.float32)
    tj = lambda a: jnp.asarray(a)  # noqa: E731
    tt = torch.tensor
    _close(j_proj.project(tj(X), tj(R), tj(t), tj(K)), t_proj.project(tt(X), tt(R), tt(t), tt(K)), rtol=1e-5, atol=1e-4)
    _close(
        j_proj.project(tj(X), tj(R), tj(t), tj(K), tj(dist)),
        t_proj.project(tt(X), tt(R), tt(t), tt(K), tt(dist)), rtol=1e-5, atol=1e-4,
    )
    _close(j_proj.undistort_points(tj(px), tj(K), tj(dist)), t_proj.undistort_points(tt(px), tt(K), tt(dist)))
    _close(
        j_proj.reprojection_error(tj(X), tj(px), tj(R), tj(t), tj(K)),
        t_proj.reprojection_error(tt(X), tt(px), tt(R), tt(t), tt(K)), atol=1e-4,
    )


def test_normalized_projection_and_depths_match():
    rng = np.random.default_rng(4)
    X = _rand(rng, 100, 3) + np.array([0, 0, 5], np.float32)
    X[:3, 2] = [-5.0, 0.0, 1e-14]  # behind, on and at the camera plane
    R = np.asarray(j_lie.exp_so3(jnp.asarray(_rand(rng, 3, scale=0.1))))
    t = _rand(rng, 3, scale=0.2)
    t[2] = 0.0
    args_j = [jnp.asarray(a) for a in (X, R, t)]
    args_t = [torch.tensor(a) for a in (X, R, t)]
    _close(j_proj.project_normalized(*args_j), t_proj.project_normalized(*args_t), rtol=1e-5, atol=1e-6)
    _close(j_proj.depths(*args_j), t_proj.depths(*args_t), rtol=1e-5, atol=1e-6)
    z = t_proj.depths(*args_t).numpy()
    assert z[0] < 0 and np.all(z[3:] > 0)


def test_interp_samplers_match():
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(3, 20, 30)).astype(np.float32)
    x = rng.uniform(-2, 32, 200).astype(np.float32)
    y = rng.uniform(-2, 22, 200).astype(np.float32)
    _close(
        j_interp.bilinear_sample(jnp.asarray(img[0]), jnp.asarray(x), jnp.asarray(y)),
        t_interp.bilinear_sample(torch.tensor(img[0]), torch.tensor(x), torch.tensor(y)),
    )
    s, yy, xx = (rng.integers(0, n, 50) for n in (3, 20, 30))
    _close(
        j_interp.gather_cube(jnp.asarray(img), jnp.asarray(s), jnp.asarray(yy), jnp.asarray(xx)),
        t_interp.gather_cube(torch.tensor(img), torch.tensor(s), torch.tensor(yy), torch.tensor(xx)),
        rtol=0, atol=0,
    )


def test_triangulation_matches(synthetic_scene):
    sc = synthetic_scene
    K = sc["K"].astype(np.float32)
    R1, t1 = sc["R"][0].astype(np.float32), sc["t"][0].astype(np.float32)
    R2, t2 = sc["R"][3].astype(np.float32), sc["t"][3].astype(np.float32)
    rng = np.random.default_rng(3)
    px1 = (sc["obs"][0] + rng.normal(0, 0.5, sc["obs"][0].shape)).astype(np.float32)
    px2 = (sc["obs"][3] + rng.normal(0, 0.5, sc["obs"][3].shape)).astype(np.float32)
    px2[:10] += 40.0  # gross outliers the 6 px gate must drop
    x1 = ((px1 - K[:2, 2]) / K[0, 0]).astype(np.float32)
    x2 = ((px2 - K[:2, 2]) / K[0, 0]).astype(np.float32)
    valid = np.ones(len(x1), bool)
    valid[-5:] = False
    args = (R1, t1, R2, t2, x1, x2, px1, px2, K, valid)
    Xj, kj = j_tri.triangulate_and_filter(*(jnp.asarray(a) for a in args))
    Xt, kt = t_tri.triangulate_and_filter(*(torch.tensor(a) for a in args))
    _close(Xj, Xt, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(kj), kt.numpy())
    assert not kt[:10].any() and kt[10:-5].all()
