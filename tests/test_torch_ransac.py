"""Parity of the port's RANSAC geometry (sfm_danpipeline_torch.ops.epipolar,
homography, pnp) with the JAX reference. The port cannot reproduce JAX's
threefry draws, so each test draws the reference's sample indices with its
own key and injects them into the port (`samples=`).

Models are compared as the estimators' sign-free outputs: E up to scale
and sign, poses after the cheirality test (rotation angle and baseline
direction), H up to scale. Tolerances: 2e-3 rad / 2e-3 on unit vectors /
1e-3 relative on H — eigh/svd differ in their last bits between backends,
and the Gauss-Newton polish carries that to ~1e-4; inlier masks agree on
>= 99% of rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_danpipeline_tpu.ops import epipolar as j_epi
from sfm_danpipeline_tpu.ops import homography as j_h
from sfm_danpipeline_tpu.ops import pnp as j_pnp
from sfm_danpipeline_tpu.ops.ransac import sample_indices as j_sample
from sfm_danpipeline_torch.ops import epipolar as t_epi
from sfm_danpipeline_torch.ops import homography as t_h
from sfm_danpipeline_torch.ops import pnp as t_pnp
from torch_testing import one_torch_thread  # noqa: F401


def _rot_angle(Ra, Rb):
    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def _two_view(scene, va=0, vb=2, n_out=30, seed=0):
    rng = np.random.default_rng(seed)
    K = scene["K"]
    obs = scene["obs"]
    px1 = obs[va] + rng.normal(0, 0.3, obs[va].shape)
    px2 = obs[vb] + rng.normal(0, 0.3, obs[vb].shape)
    px2[:n_out] = rng.uniform(0, 640, (n_out, 2))
    x1 = (px1 - K[:2, 2]) / K[0, 0]
    x2 = (px2 - K[:2, 2]) / K[0, 0]
    valid = np.ones(len(x1), bool)
    valid[-8:] = False
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(x1), f32(x2), f32(px1), f32(px2), valid


@pytest.mark.parametrize("basins", [False, True])
def test_relative_pose_matches_with_injected_samples(synthetic_scene, basins):
    x1, x2, _, _, valid = _two_view(synthetic_scene)
    key = jax.random.key(7)
    f = float(synthetic_scene["K"][0, 0])
    jfn = j_epi.estimate_relative_pose_basins if basins else j_epi.estimate_relative_pose
    tfn = t_epi.estimate_relative_pose_basins if basins else t_epi.estimate_relative_pose
    pj = jfn(key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), focal=f)
    samples = torch.tensor(np.asarray(j_sample(key, jnp.asarray(valid), 512, 8)))
    pt = tfn(None, torch.tensor(x1), torch.tensor(x2), torch.tensor(valid), focal=f, samples=samples)
    n_cand = 2 if basins else 1
    for b in range(n_cand):
        get_j = (lambda a: np.asarray(a)[b]) if basins else np.asarray
        get_t = (lambda a: a[b].numpy()) if basins else (lambda a: a.numpy())
        assert bool(get_j(pj.ok)) == bool(get_t(pt.ok))
        if not bool(get_j(pj.ok)):
            continue
        assert _rot_angle(get_j(pj.R), get_t(pt.R)) < 2e-3
        np.testing.assert_allclose(get_t(pt.t), get_j(pj.t), atol=2e-3)
        Ej, Et = get_j(pj.E), get_t(pt.E)
        Ej, Et = Ej / np.linalg.norm(Ej), Et / np.linalg.norm(Et)
        assert min(np.abs(Ej - Et).max(), np.abs(Ej + Et).max()) < 2e-3
        agree = np.mean(get_j(pj.inliers) == get_t(pt.inliers))
        assert agree >= 0.99, agree
    # Ground truth: the true relative rotation is recovered.
    R_true = synthetic_scene["R"][2] @ synthetic_scene["R"][0].T
    R0 = pt.R[0].numpy() if basins else pt.R.numpy()
    assert _rot_angle(R0, R_true) < 0.02


def test_sampson_and_decomposition_match(synthetic_scene):
    x1, x2, _, _, _ = _two_view(synthetic_scene)
    rng = np.random.default_rng(1)
    E = rng.normal(size=(3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        j_epi.sampson_distance(jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2)),
        t_epi.sampson_distance(torch.tensor(E), torch.tensor(x1), torch.tensor(x2)).numpy(),
        rtol=1e-4, atol=1e-9,
    )
    Rj, _ = j_epi.decompose_essential(jnp.asarray(E))
    Rt, _ = t_epi.decompose_essential(torch.tensor(E))
    # The four candidates as a set of rotations (sign choices may permute);
    # compared entrywise (arccos near 1 would amplify f32 rounding).
    for r in np.asarray(Rj):
        assert min(np.abs(r - q).max() for q in Rt.numpy()) < 1e-4


def test_homography_matches_with_injected_samples():
    rng = np.random.default_rng(2)
    H_true = np.array([[1.05, 0.02, 12.0], [-0.03, 0.97, -7.0], [1e-4, -5e-5, 1.0]])
    x1 = rng.uniform(0, 640, (150, 2))
    h = np.c_[x1, np.ones(150)] @ H_true.T
    x2 = h[:, :2] / h[:, 2:] + rng.normal(0, 0.3, (150, 2))
    x2[:20] = rng.uniform(0, 640, (20, 2))
    x1, x2 = x1.astype(np.float32), x2.astype(np.float32)
    valid = np.ones(150, bool)
    valid[-5:] = False
    key = jax.random.key(3)
    Hj, inl_j, nj = j_h.homography_ransac(key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), 2.0)
    samples = torch.tensor(np.asarray(j_sample(key, jnp.asarray(valid), 256, 4)))
    Ht, inl_t, nt = t_h.homography_ransac(
        None, torch.tensor(x1), torch.tensor(x2), torch.tensor(valid), 2.0, samples=samples
    )
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-3, atol=1e-3 * np.abs(H_true).max())
    assert int(nt) == int(nj)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))


@pytest.mark.parametrize("strict", [False, True])
def test_pnp_matches_with_injected_samples(synthetic_scene, strict):
    sc = synthetic_scene
    rng = np.random.default_rng(4)
    K = sc["K"].astype(np.float32)
    v = 4
    X = (sc["points"] + rng.normal(0, 1e-3, sc["points"].shape)).astype(np.float32)
    px = (sc["obs"][v] + rng.normal(0, 0.5, sc["obs"][v].shape)).astype(np.float32)
    px[:40] = rng.uniform(0, 640, (40, 2))
    xn = ((px - K[:2, 2]) / K[0, 0]).astype(np.float32)
    valid = np.ones(len(X), bool)
    valid[-10:] = False
    mask = (np.arange(len(X)) % 3 == 0) if strict else None
    n_hyp = 512
    key = jax.random.key(5)
    kw = dict(threshold_px=3.84, n_hypotheses=n_hyp, min_inliers=30)
    rj = j_pnp.solve_pnp_ransac(
        key, jnp.asarray(X), jnp.asarray(px), jnp.asarray(xn), jnp.asarray(valid),
        jnp.asarray(K), sample_mask=None if mask is None else jnp.asarray(mask), **kw,
    )
    k_dlt, k_p3p, k_p3s = jax.random.split(key, 3)
    jv = jnp.asarray(valid)
    idx6 = j_sample(k_dlt, jv, max(256, n_hyp // 4), 6)
    if mask is None:
        idx3 = j_sample(k_p3p, jv, n_hyp, 3)
    else:
        st = jnp.asarray(mask) & jv
        eff = jnp.where(jnp.sum(st) >= 8, st, jv)
        idx3 = jnp.concatenate([j_sample(k_p3p, jv, n_hyp // 2, 3), j_sample(k_p3s, eff, n_hyp // 2, 3)])
    rt = t_pnp.solve_pnp_ransac(
        None, torch.tensor(X), torch.tensor(px), torch.tensor(xn), torch.tensor(valid),
        torch.tensor(K), sample_mask=None if mask is None else torch.tensor(mask),
        samples=(torch.tensor(np.asarray(idx6)), torch.tensor(np.asarray(idx3))), **kw,
    )
    assert bool(rj.ok) and bool(rt.ok)
    assert _rot_angle(np.asarray(rj.R), rt.R.numpy()) < 2e-3
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=2e-3)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 0.01 * int(rj.n_inliers) + 1
    assert _rot_angle(rt.R.numpy(), sc["R"][v]) < 0.01
