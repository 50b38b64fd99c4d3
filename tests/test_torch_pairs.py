"""Pair scoring and the all-pairs epipolar prefilter, batched over the pair
axis (sfm_danpipeline_torch.pipeline.bootstrap.score_pairs,
pipeline.incremental.epipolar_prefilter_table and the batched two-view
estimators under them), against the JAX reference and against the port's
own one-pair calls.

Input: 300 points in a 4 x 3 x 4 box seen by 6 cameras on an arc 0.25 rad
apart (0.2 px noise), 384 match slots per pair with 10% wrong matches, and
the 3 widest-apart pairs cut to 100 valid matches (below min_pair_matches,
so unusable but still estimated). Both packages take the same key
(`interop.key_from_numpy`) and draw the same samples from it: scoring splits
its key per pair and each pair's key into (essential, homography) keys
(pipeline/bootstrap.py:70, :130 of the reference); the prefilter splits its
key over the pairs (pipeline/incremental.py:119). The draws the reference
derives that way are also injected (`samples=`) where a test holds the
port's batch against its own one-pair calls.

Tolerances against the reference are those of tests/test_torch_ransac.py:
ok and usable flags and match counts equal, rotations within 2e-3 rad,
baselines within 2e-3, E within 2e-3 up to sign, inlier masks agreeing on
>= 99% of slots (inlier counts within 1% + 1 where only counts exist).
Candidate 0, the pose that scoring and the prefilter use, is held on every
pair. Candidate 1, the best pose of another basin, is held where it is
well-posed: where the reference's own candidate 1 keeps its inlier count
and moves < 1e-4 rad when its x1 moves by one ulp. Elsewhere it is the
polish of a near-flat alternative, and the reference's own answer moves by
up to 0.2 rad under that one-ulp change (measured on this data). The
estimators are held on scoring's draws: on other draws of this scene a
pair's top hypotheses can be ones whose 8-point fit is ill-conditioned in
fp32 (eigh of A^T A squares the condition number; on one such pair over
half of the 512 fits differ by more than 1e-3 between the packages, for
the port before its pair axis as well), and then the winner differs.
Against the port's own one-pair calls on the same draws: masks, flags and
counts exactly equal, R and t within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_danpipeline_tpu.config import PipelineConfig as JConfig
from sfm_danpipeline_tpu.ops import epipolar as j_epi
from sfm_danpipeline_tpu.ops.matching import PairMatches as JPairMatches
from sfm_danpipeline_tpu.ops.ransac import sample_indices as j_sample
from sfm_danpipeline_tpu.pipeline import bootstrap as j_boot
from sfm_danpipeline_tpu.pipeline import incremental as j_inc
from sfm_danpipeline_torch import interop
from sfm_danpipeline_torch.config import PipelineConfig
from sfm_danpipeline_torch.ops import epipolar as t_epi
from sfm_danpipeline_torch.ops import prng
from sfm_danpipeline_torch.ops import ransac as t_ransac
from sfm_danpipeline_torch.ops.matching import PairMatches
from sfm_danpipeline_torch.pipeline import bootstrap as t_boot
from sfm_danpipeline_torch.pipeline import incremental as t_inc
from torch_testing import one_torch_thread  # noqa: F401

M_SLOTS = 384
MAX_DIM = 640.0


def _rot_angle(Ra, Rb):
    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def _camera(angle, radius=1.5):
    """World->camera (R, t) on an arc around the box, looking at its centre."""
    c = np.array([radius * np.sin(angle), 0.2 * np.sin(2 * angle), radius * (1 - np.cos(angle))])
    z = np.array([0.0, 0.0, 6.0]) - c
    z /= np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z])
    return R, -R @ c


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(11)
    V, N = 6, 300
    X = np.c_[rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N), rng.uniform(4, 8, N)]
    K = np.array([[800.0, 0, 320.0], [0, 800.0, 240.0], [0, 0, 1.0]])
    obs = []
    for v in range(V):
        R, t = _camera(0.25 * v)
        cam = X @ R.T + t
        obs.append(cam[:, :2] / cam[:, 2:3] * K[0, 0] + K[:2, 2])
    kp = rng.uniform(0, 640, (V, M_SLOTS, 2))
    kp[:, :N] = np.stack(obs) + rng.normal(0, 0.2, (V, N, 2))
    pi, pj = np.triu_indices(V, 1)
    P = len(pi)
    idx_a = np.tile(np.arange(M_SLOTS), (P, 1))
    idx_b = idx_a.copy()
    wrong = rng.random((P, M_SLOTS)) < 0.1
    idx_b[wrong] = rng.integers(0, M_SLOTS, wrong.sum())
    valid = np.zeros((P, M_SLOTS), bool)
    valid[:, : N - 8] = True
    thin = (pj - pi) >= 4
    valid[thin, 100:] = False
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    return dict(
        kp=f32(kp), pi=i32(pi), pj=i32(pj), idx_a=i32(idx_a), idx_b=i32(idx_b), valid=valid,
        K=f32(K), dist=np.zeros(5, np.float32), n_views=V,
    )


def _t(a):
    return torch.tensor(np.asarray(a))


def _tkey(key):
    """A reference key (or a batch of them) as the port's key."""
    return interop.key_from_numpy(jax.random.key_data(key))


def _t_matches(d):
    z = torch.zeros(d["valid"].shape)
    return PairMatches(idx_a=_t(d["idx_a"]), idx_b=_t(d["idx_b"]), dist=z, lowe=z, valid=_t(d["valid"]))


def _j_matches(d):
    z = jnp.zeros(d["valid"].shape)
    return JPairMatches(
        idx_a=jnp.asarray(d["idx_a"]), idx_b=jnp.asarray(d["idx_b"]), dist=z, lowe=z,
        valid=jnp.asarray(d["valid"]),
    )


def _score_draws(key, valid, cfg):
    """The reference's scoring draws for every pair, (P, H_e, 8), (P, H_h, 4)."""
    g = cfg.geometry
    idx_e, idx_h = [], []
    for p, k in enumerate(jax.random.split(key, valid.shape[0])):
        k_e, k_h = jax.random.split(k)
        v = jnp.asarray(valid[p])
        idx_e.append(np.asarray(j_sample(k_e, v, g.essential_ransac_iters, 8)))
        idx_h.append(np.asarray(j_sample(k_h, v, g.homography_ransac_iters, 4)))
    return _t(np.stack(idx_e)), _t(np.stack(idx_h))


def _prefilter_draws(key, valid, cfg):
    """The reference's prefilter draws, (P, H_p, 8); P < 64 pairs need no
    padding chunk, so its key splits over exactly P."""
    keys = jax.random.split(key, valid.shape[0])
    return _t(np.stack([
        np.asarray(j_sample(k, jnp.asarray(v), cfg.geometry.prefilter_ransac_iters, 8))
        for k, v in zip(keys, valid)
    ]))


def _normalized(d):
    K = d["K"]
    x1 = (d["kp"][d["pi"][:, None], d["idx_a"]] - K[:2, 2]) / K[0, 0]
    x2 = (d["kp"][d["pj"][:, None], d["idx_b"]] - K[:2, 2]) / K[0, 0]
    return np.asarray(x1, np.float32), np.asarray(x2, np.float32)


def _alt_well_posed(keys, d):
    """Per pair: whether the reference's candidate 1 keeps its inlier count
    and moves < 1e-4 rad when x1 moves by one ulp."""
    x1, x2 = _normalized(d)
    f = float(d["K"][0, 0])
    out = []
    for k, a, b, v in zip(keys, x1, x2, d["valid"]):
        r = [
            j_epi.estimate_relative_pose_basins(k, jnp.asarray(xa), jnp.asarray(b), jnp.asarray(v), focal=f)
            for xa in (a, np.nextafter(a, np.float32(1)))
        ]
        out.append(
            int(r[0].n_inliers[1]) == int(r[1].n_inliers[1])
            and _rot_angle(np.asarray(r[0].R[1]), np.asarray(r[1].R[1])) < 1e-4
        )
    return np.array(out)


def _t_args(d):
    return (_t(d["kp"]), _t(d["pi"]), _t(d["pj"]), _t(d["K"]), _t(d["dist"]))


@pytest.fixture(scope="module")
def scored(pairs):
    d = pairs
    key = jax.random.key(3)
    jcfg, tcfg = JConfig(), PipelineConfig()
    js = j_boot.score_pairs(
        key, _j_matches(d), jnp.asarray(d["kp"]), jnp.asarray(d["pi"]), jnp.asarray(d["pj"]),
        jnp.asarray(d["K"]), jnp.asarray(d["dist"]), jnp.float32(MAX_DIM), jcfg,
    )
    draws = _score_draws(key, d["valid"], jcfg)
    kp, pi, pj, K, dist = _t_args(d)
    ts = t_boot.score_pairs(_tkey(key), _t_matches(d), kp, pi, pj, K, dist, MAX_DIM, tcfg)
    keys_e = [jax.random.split(k)[0] for k in jax.random.split(key, len(d["pi"]))]
    alt = _alt_well_posed(keys_e, d)
    assert alt.sum() >= 4
    return js, ts, draws, keys_e, alt


def test_score_pairs_matches_reference(pairs, scored):
    js, ts, _, _, alt = scored
    usable = np.asarray(js.usable)
    assert usable.sum() >= 10 and (~usable).sum() >= 3  # both kinds of pair are held
    np.testing.assert_array_equal(ts.usable.numpy(), usable)
    np.testing.assert_array_equal(ts.n_matches.numpy(), np.asarray(js.n_matches))
    for b, pairs_held in ((0, np.ones_like(alt)), (1, alt)):
        nj, nt = np.asarray(js.n_inliers)[pairs_held, b], ts.n_inliers[pairs_held, b].numpy()
        assert np.all(np.abs(nt - nj) <= 0.01 * nj + 1), (b, nt, nj)
        Rj, tj = np.asarray(js.R_rel)[pairs_held, b], np.asarray(js.t_rel)[pairs_held, b]
        Rt, tt = ts.R_rel[pairs_held, b].numpy(), ts.t_rel[pairs_held, b].numpy()
        for p in range(len(Rj)):
            assert _rot_angle(Rj[p], Rt[p]) < 2e-3, (b, p)
        np.testing.assert_allclose(tt, tj, atol=2e-3)
    np.testing.assert_allclose(
        ts.pose_inlier_ratio.numpy(), np.asarray(js.pose_inlier_ratio), atol=0.011
    )
    np.testing.assert_allclose(ts.h_over_e.numpy(), np.asarray(js.h_over_e), rtol=0.011)


def test_best_pair_matches_reference(scored):
    js, ts = scored[:2]
    assert int(t_boot.best_pair(ts)) == int(j_boot.best_pair(js))
    # Ties go to the lower pair, as jnp.argmax's do.
    tie = ts._replace(pose_inlier_ratio=torch.tensor([0.2, 0.7, 0.7, -1.0]))
    jtie = js._replace(pose_inlier_ratio=jnp.asarray([0.2, 0.7, 0.7, -1.0]))
    assert int(t_boot.best_pair(tie)) == int(j_boot.best_pair(jtie)) == 1


@pytest.mark.parametrize("basins", [False, True])
def test_batched_pose_matches_reference(pairs, scored, basins):
    """The batched estimators' every field against the reference's one-pair
    estimator, pair by pair, on scoring's essential keys."""
    d = pairs
    x1, x2 = _normalized(d)
    f = float(d["K"][0, 0])
    _, _, _, keys, alt = scored
    tfn = t_epi.estimate_relative_pose_basins if basins else t_epi.estimate_relative_pose
    jfn = j_epi.estimate_relative_pose_basins if basins else j_epi.estimate_relative_pose
    tkeys = torch.stack([_tkey(k) for k in keys])
    pt = tfn(tkeys, _t(x1), _t(x2), _t(d["valid"]), focal=f)
    for p in range(len(x1)):
        pj = jfn(keys[p], jnp.asarray(x1[p]), jnp.asarray(x2[p]), jnp.asarray(d["valid"][p]), focal=f)
        for b in range(2 if basins else 1):
            if b == 1 and not alt[p]:
                continue
            get_j = (lambda a: np.asarray(a)[b]) if basins else np.asarray
            get_t = (lambda a: a[p, b].numpy()) if basins else (lambda a: a[p].numpy())
            assert bool(get_j(pj.ok)) == bool(get_t(pt.ok)), (p, b)
            if not bool(get_j(pj.ok)):
                continue
            assert _rot_angle(get_j(pj.R), get_t(pt.R)) < 2e-3, (p, b)
            np.testing.assert_allclose(get_t(pt.t), get_j(pj.t), atol=2e-3)
            Ej, Et = get_j(pj.E), get_t(pt.E)
            Ej, Et = Ej / np.linalg.norm(Ej), Et / np.linalg.norm(Et)
            assert min(np.abs(Ej - Et).max(), np.abs(Ej + Et).max()) < 2e-3, (p, b)
            assert np.mean(get_j(pj.inliers) == get_t(pt.inliers)) >= 0.99, (p, b)
            assert abs(int(get_t(pt.n_inliers)) - int(get_j(pj.n_inliers))) <= 0.01 * int(get_j(pj.n_inliers)) + 1


def test_prefilter_table_matches_reference(pairs):
    d = pairs
    key = jax.random.key(5)
    jcfg, tcfg = JConfig(), PipelineConfig()
    jt = np.asarray(j_inc.epipolar_prefilter_table(
        key, jnp.asarray(d["idx_a"]), jnp.asarray(d["idx_b"]), jnp.asarray(d["valid"]),
        jnp.asarray(d["kp"]), jnp.asarray(d["pi"]), jnp.asarray(d["pj"]), jnp.asarray(d["K"]),
        jnp.asarray(d["dist"]), jcfg, d["n_views"],
    ))
    kp, pi, pj, K, dist = _t_args(d)
    tt = t_inc.epipolar_prefilter_table(
        _tkey(key), _t(d["idx_a"]), _t(d["idx_b"]), _t(d["valid"]), kp, pi, pj, K, dist, tcfg,
        d["n_views"],
    ).numpy()
    assert tt.shape == jt.shape
    for p, (i, j) in enumerate(zip(d["pi"], d["pj"])):
        assert np.mean(tt[i, j] == jt[i, j]) >= 0.99, p
        np.testing.assert_array_equal(tt[i, j], tt[j, i])
    # Pruned where the consensus is credible, passed through where not.
    assert (tt.sum() < d["valid"].sum() * 2) and (tt.sum() > 0)
    off = np.ones(tt.shape[:2], bool)
    off[d["pi"], d["pj"]] = off[d["pj"], d["pi"]] = False
    assert not tt[off].any()


def test_score_pairs_equals_one_pair_calls(pairs, scored):
    d = pairs
    _, ts, (idx_e, idx_h) = scored[:3]
    kp, _, _, K, dist = _t_args(d)
    m = _t_matches(d)
    for p, (i, j) in enumerate(zip(d["pi"], d["pj"])):
        mp = m.pair(p)
        ratio, n, usable, h_over_e, R, t, n_inl = t_boot.score_pair(
            None, mp, kp[i][mp.idx_a.long()], kp[j][mp.idx_b.long()], K, dist, MAX_DIM,
            PipelineConfig(), samples=(idx_e[p], idx_h[p]),
        )
        assert bool(usable) == bool(ts.usable[p])
        assert int(n) == int(ts.n_matches[p])
        np.testing.assert_array_equal(n_inl.numpy(), ts.n_inliers[p].numpy())
        assert float(h_over_e) == float(ts.h_over_e[p])
        assert float(torch.where(usable, ratio, -1.0)) == float(ts.pose_inlier_ratio[p])
        np.testing.assert_allclose(R.numpy(), ts.R_rel[p].numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(t.numpy(), ts.t_rel[p].numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("basins", [False, True])
def test_batched_pose_equals_one_pair_calls(pairs, basins):
    d = pairs
    x1, x2 = (_t(x) for x in _normalized(d))
    valid = _t(d["valid"])
    draws = t_ransac.sample_indices(prng.split(prng.key(4), len(valid)), valid, 512, 8)
    fn = t_epi.estimate_relative_pose_basins if basins else t_epi.estimate_relative_pose
    f = float(d["K"][0, 0])
    batch = fn(None, x1, x2, valid, focal=f, samples=draws)
    for p in range(len(valid)):
        one = fn(None, x1[p], x2[p], valid[p], focal=f, samples=draws[p])
        for name in ("inliers", "n_inliers", "ok"):
            np.testing.assert_array_equal(getattr(one, name).numpy(), getattr(batch, name)[p].numpy())
        for name in ("R", "t", "E"):
            np.testing.assert_allclose(
                getattr(one, name).numpy(), getattr(batch, name)[p].numpy(), atol=1e-6, rtol=0
            )


def test_prefilter_equals_one_pair_calls(pairs):
    d = pairs
    kp, pi, pj, K, dist = _t_args(d)
    cfg = PipelineConfig()
    valid = _t(d["valid"])
    draws = t_ransac.sample_indices(
        prng.split(prng.key(8), len(valid)), valid, cfg.geometry.prefilter_ransac_iters, 8
    )
    table = t_inc.epipolar_prefilter_table(
        None, _t(d["idx_a"]), _t(d["idx_b"]), valid, kp, pi, pj, K, dist, cfg, d["n_views"], samples=draws,
    )
    for p, (i, j) in enumerate(zip(d["pi"], d["pj"])):
        one = t_inc.epipolar_filter_matches(
            None, kp[i][_t(d["idx_a"][p]).long()], kp[j][_t(d["idx_b"][p]).long()], valid[p], K, dist, cfg,
            samples=draws[p],
        )
        np.testing.assert_array_equal(one.numpy(), table[i, j].numpy())


def test_draws_come_essential_then_homography_then_prefilter(pairs):
    """score_pairs and the prefilter draw what the reference's key tree
    gives them: scoring's key split per pair and each pair's into its
    essential and homography keys, the prefilter's key split per pair. The
    port's keyed calls equal its calls on those draws injected, and the
    draws equal the reference's, index for index."""
    d = pairs
    kp, pi, pj, K, dist = _t_args(d)
    cfg = PipelineConfig()
    jcfg = JConfig()
    valid = _t(d["valid"])
    m = _t_matches(d)
    key_s, key_p = jax.random.key(21), jax.random.key(22)
    s_key = t_boot.score_pairs(_tkey(key_s), m, kp, pi, pj, K, dist, MAX_DIM, cfg)
    f_key = t_inc.epipolar_prefilter_table(
        _tkey(key_p), m.idx_a, m.idx_b, valid, kp, pi, pj, K, dist, cfg, d["n_views"]
    )
    draws = _score_draws(key_s, d["valid"], jcfg)
    pre = _prefilter_draws(key_p, d["valid"], jcfg)
    k_e, k_h = prng.split(prng.split(_tkey(key_s), len(valid)), 2).unbind(-2)
    g = cfg.geometry
    assert torch.equal(t_ransac.sample_indices(k_e, valid, g.essential_ransac_iters, 8), draws[0])
    assert torch.equal(t_ransac.sample_indices(k_h, valid, g.homography_ransac_iters, 4), draws[1])
    s_inj = t_boot.score_pairs(None, m, kp, pi, pj, K, dist, MAX_DIM, cfg, samples=draws)
    f_inj = t_inc.epipolar_prefilter_table(
        None, m.idx_a, m.idx_b, valid, kp, pi, pj, K, dist, cfg, d["n_views"], samples=pre
    )
    for a, b in zip(s_key, s_inj):
        assert torch.equal(a, b)
    assert torch.equal(f_key, f_inj)
    # Each pair draws only its own valid slots; one pair's draws are what
    # a batch of one draws from the same key.
    assert bool(torch.all(torch.gather(valid, 1, draws[0].reshape(len(valid), -1).long())))
    k = prng.key(2)
    one = t_ransac.sample_indices(k, valid[3], 64, 8)
    batch_of_one = t_ransac.sample_indices(k[None], valid[3:4], 64, 8)
    assert torch.equal(one, batch_of_one[0])


def test_memory_slices_do_not_change_results(pairs, scored, monkeypatch):
    """Split into slices of a few pairs (a tiny memory budget), scoring and
    the prefilter give what one slice of every pair gives."""
    d = pairs
    _, ts, draws = scored[:3]
    kp, pi, pj, K, dist = _t_args(d)
    cfg = PipelineConfig()
    per_pair = t_ransac._TABLES_PER_PAIR * cfg.geometry.essential_ransac_iters * M_SLOTS * 4
    monkeypatch.setitem(t_ransac._BATCH_BYTES, "cpu", 4 * per_pair)
    assert len(t_ransac.pair_slices(len(d["pi"]), cfg.geometry.essential_ransac_iters, M_SLOTS, "cpu")) == 4
    split = t_boot.score_pairs(None, _t_matches(d), kp, pi, pj, K, dist, MAX_DIM, cfg, samples=draws)
    for a, b in zip(split, ts):
        assert torch.equal(a, b)
