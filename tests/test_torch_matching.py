"""Parity of the port's matching (sfm_danpipeline_torch.ops.matching) with
the JAX reference: `knn2_torch` against `knn2_jnp` and the Pallas kernel
`knn2_pallas` (interpret mode on the CPU), the `knn2` wrapper, and the
ratio-test matchers. The CUDA kernel itself is held against `knn2_torch`
by the gpu-marked test, which skips without a card. The inputs built to
break the kernel (co-located groups, 0/1 descriptors, a ragged keypoint
count) come from `sfm_danpipeline_torch.utils.knn_cases`, the generators
the card check uses at full size; here they run at K <= 256.

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
from sfm_danpipeline_torch.utils import knn_cases
from torch_testing import one_torch_thread  # noqa: F401


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


# The inputs built to break the kernel, at CPU size: name -> (case, whether
# the card's indices must equal the plain version's exactly).
HARD_CASES = {
    "colocated": (lambda: knn_cases.colocated_case(k=256), False),
    "binary256": (lambda: knn_cases.binary_case(k=192, d=256), True),
    "binary512": (lambda: knn_cases.binary_case(k=192, d=512), True),
    "ragged": (lambda: knn_cases.ragged_case(k=250), False),
}


@pytest.mark.parametrize("name", list(HARD_CASES))
def test_knn2_hard_cases_match_jnp(name, jnp, j_match):
    """The wrapper on CPU tensors (knn2_torch, batched over the pair list)
    against knn2_jnp pair by pair: indices equal, d2 to rtol 1e-5."""
    case = HARD_CASES[name][0]()
    got = t_match.knn2(*knn_cases.to_tensors(case, "cpu"), case.dup_r2)
    for p, (i, j) in enumerate(zip(case.pair_i, case.pair_j)):
        ref = j_match.knn2_jnp(
            jnp.asarray(case.desc[i]), jnp.asarray(case.desc[j]),
            jnp.asarray(case.valid[j]), jnp.asarray(case.xy[j]), case.dup_r2,
        )
        _assert_knn_equal(ref, tuple(g[p] for g in got))


def test_knn2_colocated_matches_pallas_interpret(jnp, j_match):
    case = knn_cases.colocated_case(k=256)
    got = t_match.knn2(*knn_cases.to_tensors(case, "cpu"), case.dup_r2)
    ref = j_match.knn2_pallas(
        jnp.asarray(case.desc[0]), jnp.asarray(case.desc[1]),
        jnp.asarray(case.valid[1]), jnp.asarray(case.xy[1]),
        tile_a=128, dup_r2=case.dup_r2,
    )
    _assert_knn_equal(ref, tuple(g[0] for g in got))


def test_knn2_candidate_lists_are_exact_or_flagged():
    """A CPU model of the CUDA kernel's one-pass selection on the co-located
    case; it proves the algorithm, not the kernel, which only the gpu-marked
    test and the card check run. Each of 16 threads keeps its 2 smallest
    (d2, column) over the columns c = tx (mod 16); best is the lexicographic
    minimum; T the smallest of the threads' last entries; second the smallest
    listed candidate the best does not exclude. Wherever second <= T it must
    be the plain version's second; the other rows are the ones the kernel
    hands to its exact second sweep."""
    cand = 2
    case = knn_cases.colocated_case(k=256)
    desc, valid, xy, pi, pj = knn_cases.to_tensors(case, "cpu")
    i_ref, b_ref, s_ref = t_match.knn2(desc, valid, xy, pi, pj, case.dup_r2)
    n_flagged = 0
    for p in range(pi.numel()):
        a, b = desc[pi[p]], desc[pj[p]]
        d2 = torch.clamp((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None] - 2.0 * (a @ b.T), min=0.0)
        d2 = torch.where(valid[pj[p]][None], d2, torch.full_like(d2, 3.4e38))
        K = d2.shape[1]
        cand_d, cand_c, last = [], [], []
        for tx in range(16):
            cols = torch.arange(tx, K, 16)
            order = torch.sort(d2[:, cols], dim=1, stable=True).indices[:, :cand]
            cand_c.append(cols[order])
            cand_d.append(torch.gather(d2[:, cols], 1, order))
            last.append(cand_d[-1][:, -1])
        cand_d, cand_c = torch.cat(cand_d, 1), torch.cat(cand_c, 1)
        T = torch.stack(last, 1).min(1).values
        key = cand_d.double() * 2**32 + cand_c  # (d2, column) lexicographic
        bi = torch.gather(cand_c, 1, key.argmin(1, keepdim=True))[:, 0]
        assert torch.equal(bi.int(), i_ref[p])
        dxy = xy[pj[p]][cand_c] - xy[pj[p]][bi][:, None]
        excl = (cand_c == bi[:, None]) | ((dxy * dxy).sum(-1) <= case.dup_r2)
        sec = torch.where(excl, torch.full_like(cand_d, 3.4e38), cand_d).min(1).values
        ok = sec <= T
        n_flagged += int((~ok).sum())
        torch.testing.assert_close(sec[ok], s_ref[p][ok], rtol=1e-5, atol=1e-6)
    assert n_flagged > 0  # the case does reach the second sweep


def test_knn2_kernel_width():
    """The kernel takes widths in multiples of 4 (others are zero-padded) up
    to KNN2_MAX_D; a wider descriptor raises before anything is built."""
    assert t_match._kernel_width(128) == 128
    assert t_match._kernel_width(130) == 132
    assert t_match._kernel_width(t_match.KNN2_MAX_D) == t_match.KNN2_MAX_D
    with pytest.raises(ValueError, match="exceeds"):
        t_match._kernel_width(t_match.KNN2_MAX_D + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["matches", *HARD_CASES, "width130"])
def test_knn2_kernel_matches_plain_on_cuda(name):
    """The hand-written CUDA kernel against knn2_torch on the card: indices
    equal except at near-ties (|d2 difference| <= 1e-5 * max(1, d2)) and
    equal outright on 0/1 descriptors, distances rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    width = 130 if name == "width130" else 128  # 130 is zero-padded to 132
    make, exact_idx = HARD_CASES.get(name, (lambda: knn_cases.matches_case(3, 256, width), False))
    case = make()
    desc, valid, xy, pi, pj = knn_cases.to_tensors(case, "cuda")
    before = t_match.knn2.launches
    got = t_match.knn2(desc, valid, xy, pi, pj, case.dup_r2)
    torch.cuda.synchronize()
    assert t_match.knn2.launches == before + 1
    pil, pjl = pi.long(), pj.long()
    ref = t_match.knn2_torch(desc[pil], desc[pjl], valid[pjl], xy[pjl], case.dup_r2)
    knn_cases.compare_knn2(
        got, ref, desc, valid, pi, pj, rtol=1e-5, atol=1e-6, tie=1e-5, exact_idx=exact_idx
    )
    if name == "colocated":
        assert int(t_match.knn2.last_flagged) > 0
