"""The port's random draws (sfm_danpipeline_torch.ops.prng and
ops.ransac.sample_indices) against `jax.random` and the reference's
`sample_indices`, bit for bit, and the estimators drawing from one key in
both packages.

The reference draws every RANSAC sample from a threefry2x32 key tree
(`jax.random.key`, `split`, `fold_in`, `randint`); the port computes the
same hash in torch int64 ops. Every case here is held exactly: keys, bits,
randint values and sample indices equal, element for element, including
per-problem bounds, a bound of 1, bounds up to 4096 and past 2**16 (where
uint32's wrap of randint's multiplier shows), batched keys (P, 2) and the
prefix a padded split shares with the plain one.

The estimators then take the same key in both packages, with no injected
samples: the essential pose and its basins, the homography, PnP (with and
without the strict subset) and Sim(3). Their draws are equal index for
index, and their results are held at tests/test_torch_ransac.py's and
tests/test_torch_merge.py's tolerances on those files' well-posed cases.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_danpipeline_tpu.ops import epipolar as j_epi
from sfm_danpipeline_tpu.ops import homography as j_h
from sfm_danpipeline_tpu.ops import pnp as j_pnp
from sfm_danpipeline_tpu.ops import similarity as j_sim
from sfm_danpipeline_tpu.ops.ransac import sample_indices as j_sample
from sfm_danpipeline_torch import interop
from sfm_danpipeline_torch.ops import epipolar as t_epi
from sfm_danpipeline_torch.ops import homography as t_h
from sfm_danpipeline_torch.ops import pnp as t_pnp
from sfm_danpipeline_torch.ops import prng
from sfm_danpipeline_torch.ops import similarity as t_sim
from sfm_danpipeline_torch.ops.ransac import sample_indices
from test_similarity import _random_sim3
from test_torch_ransac import _rot_angle, _two_view
from torch_testing import one_torch_thread  # noqa: F401


def _data(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _tkey(key):
    return interop.key_from_numpy(jax.random.key_data(key))


def test_jax_threefry_is_partitionable():
    """ops/prng.py follows JAX's partitionable threefry; a JAX whose default
    changes would draw other bits, so it must fail here first."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 3, 7, 2**31 - 1, -1])
def test_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.key(seed).numpy(), _data(jax.random.key(seed)))


@pytest.mark.parametrize("n", [2, 3, 6 * 32, 50 * 32])
def test_split_matches_jax(n):
    k = jax.random.key(7)
    np.testing.assert_array_equal(prng.split(prng.key(7), n).numpy(), _data(jax.random.split(k, n)))


def test_padded_split_shares_its_prefix():
    """The reference's prefilter splits over P + pad pairs (its 64-pair
    chunks); pair p's key is that of a split over P."""
    k = jax.random.key(5)
    P, pad = 45, 19
    padded = _data(jax.random.split(k, P + pad))[:P]
    np.testing.assert_array_equal(prng.split(prng.key(5), P).numpy(), padded)


@pytest.mark.parametrize("data", [0, 1, 0x9E1F, 2**32 - 1])
def test_fold_in_matches_jax(data):
    np.testing.assert_array_equal(
        prng.fold_in(prng.key(7), data).numpy(), _data(jax.random.fold_in(jax.random.key(7), data))
    )


@pytest.mark.parametrize("shape", [(3,), (512, 8), (5, 7, 3)])
def test_random_bits_match_jax(shape):
    k = jax.random.key(11)
    ref = np.asarray(jax.random.bits(k, shape)).astype(np.int64)
    np.testing.assert_array_equal(prng.random_bits(prng.key(11), shape).numpy(), ref)


@pytest.mark.parametrize("maxval", [1, 5, 37, 2048, 4096, 65537, 0])
def test_randint_matches_jax(maxval):
    k = jax.random.key(7)
    ref = np.asarray(jax.random.randint(k, (512, 8), 0, maxval))
    np.testing.assert_array_equal(prng.randint(prng.key(7), (512, 8), maxval).numpy(), ref)


@pytest.mark.parametrize("n_keys", [4, 45])
def test_randint_per_key_bound_matches_vmapped_jax(n_keys):
    """A batch of keys (P, 2), each with its own bound, in one call."""
    k = jax.random.key(13)
    keys = jax.random.split(k, n_keys)
    bounds = np.random.default_rng(n_keys).integers(1, 4097, n_keys)
    bounds[0] = 1
    ref = np.asarray(jax.vmap(lambda kk, m: jax.random.randint(kk, (64, 3), 0, m))(keys, jnp.asarray(bounds)))
    out = prng.randint(_tkey(keys), (64, 3), torch.tensor(bounds))
    np.testing.assert_array_equal(out.numpy(), ref)


def _valid_rows(P, M, seed):
    """P validity masks of M slots with very different counts: all valid,
    one valid, none valid, and random densities."""
    rng = np.random.default_rng(seed)
    valid = rng.random((P, M)) < rng.uniform(0.05, 0.95, (P, 1))
    valid[0] = True
    valid[1] = False
    valid[1, M // 2] = True
    valid[2] = False
    return valid


@pytest.mark.parametrize("H,s", [(512, 8), (256, 4), (1024, 3)])
def test_sample_indices_match_reference(H, s):
    valid = _valid_rows(6, 384, H)
    k = jax.random.key(H)
    keys = jax.random.split(k, len(valid))
    ref = np.stack([np.asarray(j_sample(kk, jnp.asarray(v), H, s)) for kk, v in zip(keys, valid)])
    batch = sample_indices(_tkey(keys), torch.tensor(valid), H, s)
    np.testing.assert_array_equal(batch.numpy(), ref)
    one = sample_indices(_tkey(keys[3]), torch.tensor(valid[3]), H, s)
    np.testing.assert_array_equal(one.numpy(), ref[3])


def test_sample_indices_refuse_a_key_per_problem_mismatch():
    valid = torch.ones((3, 16), dtype=torch.bool)
    with pytest.raises(ValueError, match="keys"):
        sample_indices(prng.key(0), valid, 8, 3)


@pytest.mark.parametrize("maxval", [2**31, torch.tensor([5, 2**31, 7])], ids=["int", "tensor"])
def test_randint_refuses_bounds_past_int32(maxval):
    """jax.random.randint's int32 bound; past it the int64 products of the
    fold would overflow. Checked on the host, before any draw."""
    keys = prng.split(prng.key(0), 3)
    with pytest.raises(ValueError, match="int32"):
        prng.randint(keys if torch.is_tensor(maxval) else keys[0], (4,), maxval)


def test_key_from_numpy():
    k = jax.random.split(jax.random.key(9), 4)
    t = interop.key_from_numpy(jax.random.key_data(k))
    assert t.dtype == torch.int64 and tuple(t.shape) == (4, 2)
    np.testing.assert_array_equal(t.numpy(), _data(k))
    with pytest.raises(TypeError):
        interop.key_from_numpy(np.zeros((2,), np.int64))


def test_no_torch_generator_on_the_ransac_path():
    """Every draw of the port comes from a key: no torch.Generator and no
    torch.rand* in the package."""
    root = pathlib.Path(__file__).resolve().parents[1] / "sfm_danpipeline_torch"
    for path in root.rglob("*.py"):
        text = path.read_text()
        for word in ("torch.Generator", "torch.rand", "manual_seed"):
            assert word not in text, (path.name, word)


# ---------------------------------------------------------------------------
# The estimators, one key in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("basins", [False, True])
def test_relative_pose_with_one_key(synthetic_scene, basins):
    x1, x2, _, _, valid = _two_view(synthetic_scene)
    key = jax.random.key(7)
    f = float(synthetic_scene["K"][0, 0])
    jfn = j_epi.estimate_relative_pose_basins if basins else j_epi.estimate_relative_pose
    tfn = t_epi.estimate_relative_pose_basins if basins else t_epi.estimate_relative_pose
    pj = jfn(key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), focal=f)
    pt = tfn(_tkey(key), torch.tensor(x1), torch.tensor(x2), torch.tensor(valid), focal=f)
    for b in range(2 if basins else 1):
        get_j = (lambda a: np.asarray(a)[b]) if basins else np.asarray
        get_t = (lambda a: a[b].numpy()) if basins else (lambda a: a.numpy())
        assert bool(get_j(pj.ok)) == bool(get_t(pt.ok))
        if not bool(get_j(pj.ok)):
            continue
        assert _rot_angle(get_j(pj.R), get_t(pt.R)) < 2e-3
        np.testing.assert_allclose(get_t(pt.t), get_j(pj.t), atol=2e-3)
        assert np.mean(get_j(pj.inliers) == get_t(pt.inliers)) >= 0.99


def test_homography_with_one_key():
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
    Ht, inl_t, nt = t_h.homography_ransac(
        _tkey(key), torch.tensor(x1), torch.tensor(x2), torch.tensor(valid), 2.0
    )
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-3, atol=1e-3 * np.abs(H_true).max())
    assert int(nt) == int(nj)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))


@pytest.mark.parametrize("strict", [False, True])
def test_pnp_with_one_key(synthetic_scene, strict):
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
    # The draws: the key split three ways as the reference splits it.
    k_dlt, k_p3p, k_p3s = jax.random.split(key, 3)
    jv = jnp.asarray(valid)
    idx6 = j_sample(k_dlt, jv, max(256, n_hyp // 4), 6)
    if mask is None:
        idx3 = j_sample(k_p3p, jv, n_hyp, 3)
    else:
        st = jnp.asarray(mask) & jv
        eff = jnp.where(jnp.sum(st) >= 8, st, jv)
        idx3 = jnp.concatenate([j_sample(k_p3p, jv, n_hyp // 2, 3), j_sample(k_p3s, eff, n_hyp // 2, 3)])
    tmask = None if mask is None else torch.tensor(mask)
    t6, t3 = t_pnp.pnp_sample_draws(_tkey(key), torch.tensor(valid), n_hyp, 6, tmask)
    np.testing.assert_array_equal(t6.numpy(), np.asarray(idx6))
    np.testing.assert_array_equal(t3.numpy(), np.asarray(idx3))
    rt = t_pnp.solve_pnp_ransac(
        _tkey(key), torch.tensor(X), torch.tensor(px), torch.tensor(xn), torch.tensor(valid),
        torch.tensor(K), sample_mask=tmask, **kw,
    )
    assert bool(rj.ok) and bool(rt.ok)
    assert _rot_angle(np.asarray(rj.R), rt.R.numpy()) < 2e-3
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=2e-3)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 0.01 * int(rj.n_inliers) + 1


def test_sim3_with_one_key():
    """tests/test_torch_merge.py's outlier case: 80 of 200 rows wrong."""
    rng = np.random.default_rng(2)
    sim = _random_sim3(rng)
    M = 200
    X = (rng.normal(size=(M, 3)) * 3).astype(np.float32)
    Y = np.array(j_sim.apply_sim3(sim, jnp.asarray(X)))
    Y = (Y + rng.normal(size=(M, 3)) * 0.002).astype(np.float32)
    Y[:80] = (rng.normal(size=(80, 3)) * 10).astype(np.float32)
    valid = np.ones(M, bool)
    valid[-7:] = False
    key, thr = jax.random.key(0), 0.05
    rj = j_sim.estimate_sim3_ransac(key, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(valid), threshold=thr)
    t = torch.tensor
    rt = t_sim.estimate_sim3_ransac(_tkey(key), t(X), t(Y), t(valid), threshold=thr)
    assert bool(rt.ok) and bool(rj.ok)
    assert int(rt.n_inliers) == int(rj.n_inliers) >= 100
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    np.testing.assert_allclose(float(rt.sim.s), float(rj.sim.s), rtol=1e-5)
    np.testing.assert_allclose(rt.sim.R.numpy(), np.asarray(rj.sim.R), atol=1e-5)
    np.testing.assert_allclose(rt.sim.t.numpy(), np.asarray(rj.sim.t), atol=1e-4)
