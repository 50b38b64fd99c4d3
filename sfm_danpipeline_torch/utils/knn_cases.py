"""Input generators for checks of the top-2 search `ops.matching.knn2`.

The inputs are numpy, made from a seed. Every generator returns a `KnnCase` in the
batched layout that `knn2` takes: descriptors (N, K, D) f32, valid (N, K)
bool, xy (N, K, 2) f32, pair_i / pair_j (P,) int32 and the squared
co-location radius `dup_r2`. The CPU parity tests run them at K <= 256
against the reference; the card check runs them at full size against
`knn2_torch`, both through `compare_knn2`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class KnnCase(NamedTuple):
    desc: np.ndarray
    valid: np.ndarray
    xy: np.ndarray
    pair_i: np.ndarray
    pair_j: np.ndarray
    dup_r2: float


def _unit(x: np.ndarray) -> np.ndarray:
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _all_pairs(n: int):
    pi, pj = np.triu_indices(n, 1)
    return pi.astype(np.int32), pj.astype(np.int32)


def matches_case(
    n_views: int = 10, k: int = 2048, d: int = 128, dup_r2: float = 0.25, seed: int = 0
) -> KnnCase:
    """Unit descriptors with true matches between consecutive views, ~10%
    invalid rows and ~10% co-located twins (same xy, near-duplicate
    descriptor) per view; every i < j pair. The default is the matching
    stage's shape on a 10-view run (45 pairs of 2048 SIFT descriptors)."""
    rng = np.random.default_rng(seed)
    desc = rng.normal(size=(n_views, k, d)).astype(np.float32)
    xy = rng.uniform(0, 640, size=(n_views, k, 2)).astype(np.float32)
    for v in range(n_views):
        twins = rng.choice(k, k // 10, replace=False)
        src = rng.choice(k, k // 10, replace=False)
        desc[v, twins] = desc[v, src] + 0.2 * rng.normal(size=(k // 10, d))
        xy[v, twins] = xy[v, src]
        # Half of each view's rows are noisy copies of the next view's rows.
        half = rng.choice(k, k // 2, replace=False)
        desc[v, half] = desc[(v + 1) % n_views, half] + 0.3 * rng.normal(
            size=(k // 2, d)
        )
    valid = rng.uniform(size=(n_views, k)) > 0.1
    return KnnCase(_unit(desc), valid, xy, *_all_pairs(n_views), dup_r2)


def colocated_case(k: int = 2048, d: int = 128, seed: int = 1) -> KnnCase:
    """Two views of one set of physical points, about half of each view's
    rows in groups of 3-6 rows that share a position and carry near-duplicate
    descriptors, at random row indices. The best match of such a point has
    2-5 co-located twins that all beat the true runner-up, so a search that
    keeps a short candidate list has to take its exact second sweep."""
    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < k // 2:
        sizes.append(3 + len(sizes) % 4)
    n_points = len(sizes) + (k - sum(sizes))
    point_of_row = np.concatenate(
        [np.repeat(np.arange(len(sizes)), sizes), np.arange(len(sizes), n_points)]
    )[:k]
    base = rng.normal(size=(n_points, d))
    desc = np.empty((2, k, d), np.float32)
    xy = np.empty((2, k, 2), np.float32)
    for v in range(2):
        rows = point_of_row[rng.permutation(k)]
        pos = rng.uniform(0, 640, size=(n_points, 2))
        desc[v] = _unit(base[rows] + 0.05 * rng.normal(size=(k, d)))
        xy[v] = pos[rows]
    valid = rng.uniform(size=(2, k)) > 0.1
    pairs = np.array([0, 1], np.int32)
    return KnnCase(desc, valid, xy, pairs, pairs[::-1].copy(), 0.25)


def binary_case(k: int = 2048, d: int = 256, seed: int = 2) -> KnnCase:
    """0/1 descriptors (binary detectors' bits as floats): every row is one
    of 64 prototypes with 0-3 bits flipped, so squared distances are small
    integers that tie by the hundred, exact duplicates included. All sums are
    exact in float32, so only the lowest-index tie-break gives equal indices.
    A quarter of the rows share their position with another row."""
    rng = np.random.default_rng(seed)
    protos = rng.integers(0, 2, size=(64, d))
    desc = protos[rng.integers(0, 64, size=(3, k))]
    flips = rng.integers(0, 4, size=(3, k))
    for n in range(1, 4):
        v, r = np.nonzero(flips >= n)
        c = rng.integers(0, d, size=v.size)
        desc[v, r, c] ^= 1
    xy = rng.uniform(0, 640, size=(3, k, 2)).astype(np.float32)
    for v in range(3):
        dup = rng.choice(k, k // 4, replace=False)
        xy[v, dup] = xy[v, rng.choice(k, k // 4, replace=False)]
    valid = rng.uniform(size=(3, k)) > 0.1
    return KnnCase(desc.astype(np.float32), valid, xy, *_all_pairs(3), 0.25)


def ragged_case(k: int = 1000, d: int = 128, seed: int = 3) -> KnnCase:
    """A keypoint count that no tile size divides, with the co-location
    exclusion off (`dup_r2` = -1): three views of `matches_case`."""
    return matches_case(n_views=3, k=k, d=d, dup_r2=-1.0, seed=seed)


def to_tensors(case: KnnCase, device):
    """(desc, valid, xy, pair_i, pair_j) of `case` as tensors on `device`."""
    return tuple(torch.as_tensor(a, device=device) for a in case[:5])


def compare_knn2(got, ref, desc, valid, pair_i, pair_j, *, rtol, atol, tie, exact_idx=False):
    """Hold one top-2 result (idx, best, second), each (P, K), against
    another on the same inputs; raises AssertionError on a disagreement.

    Indices are equal (`exact_idx`), or differ only where the two chosen
    columns' squared distances, recomputed in float64, agree within
    `tie` * max(1, d2). Distances agree within atol + rtol * |ref|, and both
    results carry the 3.4e38 sentinel on the same rows. Returns the number
    of index mismatches and the largest |distance error|."""
    (ig, bg, sg), (ir, br, sr) = got, ref
    mism = ig != ir
    n_mism = int(mism.sum())
    if exact_idx:
        if n_mism:
            raise AssertionError(f"knn2: {n_mism} index mismatches, none allowed")
    elif n_mism:
        pil, pjl = pair_i.long(), pair_j.long()
        p, r = torch.nonzero(mism, as_tuple=True)
        a64 = desc[pil[p], r].double()

        def d2_at(idx):
            c = idx[p, r].long()
            d = ((a64 - desc[pjl[p], c].double()) ** 2).sum(-1)
            return torch.where(valid[pjl[p], c], d, torch.full_like(d, 3.4e38))

        dg, dr = d2_at(ig), d2_at(ir)
        off = (dg - dr).abs() > tie * torch.clamp(dr, min=1.0)
        if bool(off.any()):
            raise AssertionError(f"knn2: {int(off.sum())} index mismatches off a near-tie")
    if not torch.equal(sg >= 3.4e38, sr >= 3.4e38):
        raise AssertionError("knn2: second-best sentinel rows differ")
    finite = sr < 3.4e38
    max_err = 0.0
    for name, g, r, m in (("best", bg, br, torch.ones_like(finite)), ("second", sg, sr, finite)):
        err = (g - r).abs()
        bad = m & ~(err <= atol + rtol * r.abs())
        if bool(bad.any()):
            raise AssertionError(
                f"knn2 {name} d2 disagrees at {int(bad.sum())} rows "
                f"(max err {float(err[m].max()):.3e})"
            )
        if bool(m.any()):
            max_err = max(max_err, float(err[m].max()))
    return n_mism, max_err
