"""Parity of the port's matching (sfm_danpipeline_torch.ops.matching) with
the JAX reference: `knn2_torch` against `knn2_jnp` and the Pallas kernel
`knn2_pallas` (interpret mode on the CPU), the `knn2` wrapper, and the
ratio-test matchers. The CUDA kernel itself is held against `knn2_torch`
by the gpu-marked test, which skips without a card.

Tolerances: indices equal; squared distances rtol 1e-5 (atol 1e-6) — the
same f32 matmul identity, summed in another order. Match sets are compared
as sets of valid slots.

The JAX side comes in through fixtures, so the gpu-marked test also runs
on a card host without JAX: `python -m pytest --noconftest -m gpu
tests/test_torch_matching.py`.
"""
import numpy as np
import pytest
import torch

from sfm_danpipeline_torch.ops import matching as t_match


@pytest.fixture(scope="module")
def jnp():
    return pytest.importorskip("jax.numpy")


@pytest.fixture(scope="module")
def j_match():
    return pytest.importorskip("sfm_danpipeline_tpu.ops.matching")

DUP_R2 = 0.25


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _knn_case(seed=0, ka=300, kb=256):
    """Random descriptors with true matches, invalid B rows and co-located
    twins (same xy, near-duplicate descriptor) of B rows."""
    rng = np.random.default_rng(seed)
    b = _unit(rng, kb, 128)
    xy = rng.uniform(0, 100, (kb, 2)).astype(np.float32)
    nt = kb // 12
    twins = rng.choice(kb, 2 * nt, replace=False)
    b[twins[:nt]] = b[twins[nt:]] + 0.02 * rng.normal(size=(nt, 128))
    xy[twins[:nt]] = xy[twins[nt:]]
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    a = _unit(rng, ka, 128)
    src = rng.choice(kb, ka // 2)
    a[: ka // 2] = b[src] + 0.03 * rng.normal(size=(ka // 2, 128))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    valid_b = np.ones(kb, bool)
    valid_b[rng.choice(kb, kb // 10, replace=False)] = False
    return a, b, valid_b, xy


def _assert_knn_equal(ref, got):
    i_r, b_r, s_r = (np.asarray(x) for x in ref)
    i_g, b_g, s_g = (x.cpu().numpy() for x in got)
    np.testing.assert_array_equal(i_g, i_r)
    np.testing.assert_allclose(b_g, b_r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s_g, s_r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dup_r2", [-1.0, DUP_R2])
def test_knn2_torch_matches_jnp(dup_r2, jnp, j_match):
    a, b, vb, xy = _knn_case()
    ref = j_match.knn2_jnp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(vb), jnp.asarray(xy), dup_r2)
    got = t_match.knn2_torch(torch.tensor(a), torch.tensor(b), torch.tensor(vb), torch.tensor(xy), dup_r2)
    _assert_knn_equal(ref, got)


def test_knn2_torch_matches_pallas_interpret(jnp, j_match):
    a, b, vb, xy = _knn_case(seed=1)
    ref = j_match.knn2_pallas(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(vb), jnp.asarray(xy),
        tile_a=128, dup_r2=DUP_R2,
    )
    got = t_match.knn2_torch(torch.tensor(a), torch.tensor(b), torch.tensor(vb), torch.tensor(xy), DUP_R2)
    _assert_knn_equal(ref, got)


def test_knn2_sentinels(jnp, j_match):
    """All-invalid B: index 0 and best 3.4e38; one valid row: second 3.4e38."""
    a, b, vb, xy = _knn_case(seed=2, ka=8, kb=16)
    for n_valid in (0, 1):
        v = np.zeros_like(vb)
        v[:n_valid] = True
        ref = j_match.knn2_jnp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(v), jnp.asarray(xy), DUP_R2)
        got = t_match.knn2_torch(torch.tensor(a), torch.tensor(b), torch.tensor(v), torch.tensor(xy), DUP_R2)
        _assert_knn_equal(ref, got)
        assert np.all(got[2].numpy() >= 3.4e38)


def test_knn2_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    desc = torch.tensor(_unit(rng, 4, 64, 128))
    valid = torch.tensor(rng.uniform(size=(4, 64)) > 0.1)
    xy = torch.tensor(rng.uniform(0, 10, (4, 64, 2)).astype(np.float32))
    pi = torch.tensor([0, 0, 1, 2], dtype=torch.int32)
    pj = torch.tensor([1, 3, 2, 3], dtype=torch.int32)
    before = t_match.knn2.launches
    got = t_match.knn2(desc, valid, xy, pi, pj, DUP_R2)
    assert t_match.knn2.launches == before  # no kernel on CPU tensors
    for p in range(4):
        one = t_match.knn2_torch(desc[pi[p]], desc[pj[p]], valid[pj[p]], xy[pj[p]], DUP_R2)
        for g, r in zip(got, one):
            assert torch.equal(g[p], r)
    with pytest.raises(ValueError):
        t_match.knn2(desc.double(), valid, xy, pi, pj, DUP_R2)
    with pytest.raises(ValueError):
        t_match.knn2(desc, valid, xy, pi, pj + 4, DUP_R2)


def _valid_set(idx_a, idx_b, valid):
    return {(int(i), int(j)) for i, j, v in zip(idx_a, idx_b, valid) if bool(v)}


@pytest.mark.parametrize("dedup", [False, True])
def test_match_pair_valid_slots_match(dedup, jnp, j_match):
    a, b, vb, xy_b = _knn_case(seed=4, ka=256, kb=256)
    rng = np.random.default_rng(4)
    va = np.ones(256, bool)
    va[:10] = False
    xy_a = rng.uniform(0, 100, (256, 2)).astype(np.float32)
    kw = dict(ratio=0.9, max_matches=128, strict_ratio=0.8, dup_radius=0.5, dedup=dedup)
    mj = j_match.match_pair(
        jnp.asarray(a), jnp.asarray(va), jnp.asarray(b), jnp.asarray(vb),
        xy_a=jnp.asarray(xy_a), xy_b=jnp.asarray(xy_b), **kw,
    )
    mt = t_match.match_pair(
        torch.tensor(a), torch.tensor(va), torch.tensor(b), torch.tensor(vb),
        xy_a=torch.tensor(xy_a), xy_b=torch.tensor(xy_b), **kw,
    )
    sj = _valid_set(mj.idx_a, mj.idx_b, mj.valid)
    assert len(sj) > 20
    assert _valid_set(mt.idx_a, mt.idx_b, mt.valid) == sj
    strict_j = _valid_set(mj.idx_a, mj.idx_b, mj.at_ratio(0.8).valid)
    assert _valid_set(mt.idx_a, mt.idx_b, mt.at_ratio(0.8).valid) == strict_j


def test_match_all_pairs_valid_slots_match(jnp, j_match):
    rng = np.random.default_rng(5)
    base = _unit(rng, 200, 128)
    desc = np.stack([base + 0.04 * rng.normal(size=base.shape) for _ in range(4)])
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    desc = desc.astype(np.float32)
    valid = rng.uniform(size=(4, 200)) > 0.05
    xy = rng.uniform(0, 100, (4, 200, 2)).astype(np.float32)
    pi = np.array([0, 0, 0, 1, 1, 2], np.int32)
    pj = np.array([1, 2, 3, 2, 3, 3], np.int32)
    kw = dict(ratio=0.9, max_matches=150, strict_ratio=0.8, dup_radius=0.5, dedup=False)
    mj = j_match.match_all_pairs(
        jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(pi), jnp.asarray(pj),
        xy=jnp.asarray(xy), **kw,
    )
    mt = t_match.match_all_pairs(
        torch.tensor(desc), torch.tensor(valid), torch.tensor(pi), torch.tensor(pj),
        xy=torch.tensor(xy), **kw,
    )
    for p in range(len(pi)):
        sj = _valid_set(mj.idx_a[p], mj.idx_b[p], mj.valid[p])
        assert len(sj) > 50
        assert _valid_set(mt.idx_a[p], mt.idx_b[p], mt.valid[p]) == sj
    np.testing.assert_array_equal(mt.count.numpy(), np.asarray(mj.count))


def test_ratio_test_filters_ambiguous():
    """Two equally near neighbours are rejected, one clear neighbour kept
    (Lowe ratio 0.8)."""
    a = np.zeros((2, 128), np.float32)
    a[0, 0] = 1.0
    a[1, 1] = 1.0
    b = np.zeros((3, 128), np.float32)
    b[0, 0] = 1.0
    b[1, 1] = b[2, 1] = 0.7
    b[1, 2] = b[2, 3] = 0.1
    m = t_match.match_pair(
        torch.tensor(a), torch.ones(2, dtype=torch.bool), torch.tensor(b),
        torch.ones(3, dtype=torch.bool), max_matches=4,
    )
    got = _valid_set(m.idx_a, m.idx_b, m.valid)
    assert (0, 0) in got and all(ia != 1 for ia, _ in got)


@pytest.mark.gpu
def test_knn2_kernel_matches_plain_on_cuda():
    """The hand-written CUDA kernel against knn2_torch on the card: indices
    equal except at near-ties (|d2 difference| <= 1e-5 * max(1, d2)),
    distances rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    a, b, vb, xy = _knn_case(seed=6, ka=256, kb=256)
    desc = torch.tensor(np.stack([a[:256], b]), device="cuda")
    valid = torch.tensor(np.stack([np.ones(256, bool), vb]), device="cuda")
    xys = torch.tensor(np.stack([xy, xy]), device="cuda")
    pi = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    pj = torch.tensor([1, 0], dtype=torch.int32, device="cuda")
    before = t_match.knn2.launches
    ik, bk, sk = t_match.knn2(desc, valid, xys, pi, pj, DUP_R2)
    torch.cuda.synchronize()
    assert t_match.knn2.launches == before + 1
    ip, bp, sp = t_match.knn2_torch(desc[pi.long()], desc[pj.long()], valid[pj.long()], xys[pj.long()], DUP_R2)
    mism = ik != ip
    d2 = ((desc[pi.long()][:, :, None] - desc[pj.long()][:, None]) ** 2).sum(-1)
    dk = torch.gather(d2, 2, ik.long()[..., None])[..., 0]
    dp = torch.gather(d2, 2, ip.long()[..., None])[..., 0]
    assert bool(((dk - dp).abs()[mism] <= 1e-5 * torch.clamp(dp[mism], min=1)).all())
    torch.testing.assert_close(bk, bp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sk, sp, rtol=1e-5, atol=1e-6)
