"""The port's LK-flow matcher (sfm_danpipeline_torch.ops.flow) against the
JAX reference, and the reference's own flow test cases on the port.

Parity on two rendered 120x160 courtyard frames: `lk_track` endpoints
within 1e-3 px where the reference's track is ok and the ok masks equal (the
window sums of 441 samples round in other orders; the observed difference
is ~4e-5 px), and `flow_match_pair`'s valid (idx_a, idx_b) sets equal. The
slot order inside a match set is by association distance. The reference's
|a|^2+|b|^2-2ab form cancels to ~1e-3 px in float32, so against the
reference sets are compared, not slots; the port computes the distance from
the coordinate differences, and its association (chosen keypoint, distance,
slot order) is held to a float64 computation on the same tracked points.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from sfm_danpipeline_tpu.ops import flow as j_flow
from sfm_danpipeline_tpu.utils.synthscene import make_courtyard_scene
from sfm_danpipeline_torch.ops import flow as t_flow
from torch_testing import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def frames():
    scene = make_courtyard_scene(n_views=3, height=120, width=160, ring_fraction=0.04, seed=0)
    rng = np.random.default_rng(0)
    xy0 = rng.uniform([5, 5], [155, 115], (200, 2)).astype(np.float32)
    v0 = np.ones(200, bool)
    v0[::7] = False
    xy1 = rng.uniform([5, 5], [155, 115], (300, 2)).astype(np.float32)
    v1 = np.ones(300, bool)
    v1[::5] = False
    return scene.images.gray, xy0, v0, xy1, v1


def _pair_set(m, to_np):
    v = to_np(m.valid)
    return set(zip(to_np(m.idx_a)[v].tolist(), to_np(m.idx_b)[v].tolist()))


def test_lk_track_endpoints_agree(frames):
    g, xy0, v0, _, _ = frames
    pj, okj = j_flow.lk_track(jnp.asarray(g[0]), jnp.asarray(g[1]), jnp.asarray(xy0), jnp.asarray(v0))
    pt, okt = t_flow.lk_track(torch.tensor(g[0]), torch.tensor(g[1]), torch.tensor(xy0), torch.tensor(v0))
    okj = np.asarray(okj)
    assert okj.sum() > 100
    np.testing.assert_array_equal(okt.numpy(), okj)
    np.testing.assert_allclose(pt.numpy()[okj], np.asarray(pj)[okj], rtol=0, atol=1e-3)


def test_flow_match_pair_index_sets_equal(frames):
    g, xy0, v0, xy1, v1 = frames
    mj = j_flow.flow_match_pair(
        *(jnp.asarray(a) for a in (g[0], g[1], xy0, v0, xy1, v1)), radius=6.0, max_matches=256
    )
    mt = t_flow.flow_match_pair(
        *(torch.tensor(a) for a in (g[0], g[1], xy0, v0, xy1, v1)), radius=6.0, max_matches=256
    )
    sj, st = _pair_set(mj, np.asarray), _pair_set(mt, lambda a: a.numpy())
    assert len(sj) > 50
    assert st == sj
    assert float(mt.lowe.abs().max()) == 0.0
    # at_ratio keeps every flow match, as the reference's does.
    assert torch.equal(mt.at_ratio(0.8).valid, mt.valid)


def test_flow_match_sets_agree_at_full_size():
    """The pipeline's own size: 480x640 frames of the narrow arc the flow
    path runs on, 2048 SIFT keypoints (the port's, given to both), the
    default radius and match budget, an adjacent pair and a distant one. The
    valid (idx_a, idx_b) sets may differ only where an endpoint lies on the
    3 px radius to float32 rounding: at most 0.5% of the reference's matches."""
    from sfm_danpipeline_torch.config import FeatureConfig
    from sfm_danpipeline_torch.ops.sift import detect_and_compute_batch

    scene = make_courtyard_scene(n_views=10, ring_fraction=0.05, seed=0)
    g = scene.images.gray[[0, 1, 5]]
    kp = detect_and_compute_batch(torch.tensor(g), FeatureConfig())
    xy, valid = kp.xy.numpy(), kp.valid.numpy()
    assert valid.sum(1).min() > 500
    for a, b, floor in ((0, 1, 300), (0, 2, 50)):
        args = (g[a], g[b], xy[a], valid[a], xy[b], valid[b])
        mj = j_flow.flow_match_pair(*(jnp.asarray(x) for x in args))
        mt = t_flow.flow_match_pair(*(torch.tensor(x) for x in args))
        sj, st = _pair_set(mj, np.asarray), _pair_set(mt, lambda t: t.numpy())
        assert len(sj) > floor
        assert len(sj ^ st) <= 0.005 * len(sj), (a, b, len(sj), len(st), len(sj ^ st))


def _association_f64(pts1, ok, xy1, valid1, radius, max_matches):
    """flow_match_pair's association in float64 numpy: the nearest valid
    keypoint, its distance, and the slots by distance, lower index first on
    ties."""
    p, q = pts1.astype(np.float64), xy1.astype(np.float64)
    d2 = ((p[:, None, :] - q[None, :, :]) ** 2).sum(-1)
    d2[:, ~valid1] = np.inf
    best = np.argmin(d2, axis=1)
    bestd = np.sqrt(d2[np.arange(len(p)), best])
    keep = ok & (bestd <= radius)
    order = np.argsort(np.where(keep, bestd, np.inf), kind="stable")[:max_matches]
    return order, best[order], bestd[order], keep[order]


@pytest.mark.parametrize("size", ["frames", "full"])
def test_association_equals_float64(frames, size):
    """The chosen keypoint, the association distance and the slot order
    against float64 on the same tracked endpoints: the distance from the
    coordinate differences leaves nothing to rounding but its last bit, so
    card and CPU order the slots alike. `frames`: random keypoints on two
    120x160 frames; `full`: an adjacent pair of the narrow 480x640 arc with
    SIFT keypoints, where most endpoints lie within 0.1 px of a keypoint."""
    if size == "frames":
        g, xy0, v0, xy1, v1 = frames
        img0, img1, radius, budget = g[0], g[1], 6.0, 256
    else:
        from sfm_danpipeline_torch.config import FeatureConfig
        from sfm_danpipeline_torch.ops.sift import detect_and_compute_batch

        scene = make_courtyard_scene(n_views=10, ring_fraction=0.05, seed=0)
        gray = scene.images.gray[[0, 1]]
        kp = detect_and_compute_batch(torch.tensor(gray), FeatureConfig())
        xy0, xy1 = kp.xy[0].numpy(), kp.xy[1].numpy()
        v0, v1 = kp.valid[0].numpy(), kp.valid[1].numpy()
        img0, img1, radius, budget = gray[0], gray[1], 3.0, 1024
    args = [torch.tensor(a) for a in (img0, img1, xy0, v0, xy1, v1)]
    m = t_flow.flow_match_pair(*args, radius=radius, max_matches=budget)
    pts1, ok = t_flow.lk_track(*args[:4])
    order, best, dist, keep = _association_f64(pts1.numpy(), ok.numpy(), xy1, v1, radius, budget)
    n = int(keep.sum())
    assert n > 50 and int(m.valid.sum()) == n
    np.testing.assert_array_equal(m.valid.numpy()[:n], True)
    np.testing.assert_array_equal(m.idx_a.numpy()[:n], order[:n])
    np.testing.assert_array_equal(m.idx_b.numpy()[:n], best[:n])
    np.testing.assert_allclose(m.dist.numpy()[:n], dist[:n], rtol=1e-6, atol=1e-6)


def test_all_pairs_equals_pair_by_pair(frames):
    g, xy0, v0, _, _ = frames
    gray = torch.tensor(g)
    xy = torch.tensor(np.stack([xy0, xy0 + 0.5, xy0 - 0.25]))
    valid = torch.tensor(np.stack([v0, v0, v0]))
    pi, pj = [0, 0, 1], [1, 2, 2]
    allp = t_flow.flow_match_all_pairs(gray, xy, valid, pi, pj, radius=4.0, max_matches=128, chunk=2)
    for n, (a, b) in enumerate(zip(pi, pj)):
        one = t_flow.flow_match_pair(
            gray[a], gray[b], xy[a], valid[a], xy[b], valid[b], radius=4.0, max_matches=128
        )
        assert _pair_set(allp.pair(n), lambda t: t.numpy()) == _pair_set(one, lambda t: t.numpy())


def test_flow_front_end_matches_reference():
    """Both packages' SfMPipeline with `method="flow"` on four views of a
    narrow arc (tests/test_torch_frontends.py states what is held)."""
    from torch_v6_reference import check_front_end

    check_front_end("sift", "flow")


# --- the reference's own cases (tests/test_flow.py) on the port ---


def _smooth_texture(h, w, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(h // 4 + 2, w // 4 + 2)).astype(np.float32)
    t = ndimage.zoom(t, 4, order=3)[:h, :w]
    return ((t - t.min()) / (np.ptp(t) + 1e-9)).astype(np.float32)


def test_tracks_known_shift():
    img = _smooth_texture(120, 160, seed=1)
    shift = (2.3, -3.6)  # (dy, dx)
    img2 = ndimage.shift(img, shift, order=3, mode="nearest")
    pts = np.random.default_rng(2).uniform([20, 20], [140, 100], (50, 2)).astype(np.float32)
    p1, ok = t_flow.lk_track(
        torch.tensor(img), torch.tensor(img2), torch.tensor(pts), torch.ones(50, dtype=torch.bool)
    )
    ok = ok.numpy()
    assert ok.mean() > 0.8
    err = p1.numpy()[ok] - pts[ok] - [shift[1], shift[0]]
    assert np.abs(np.median(err, 0)).max() < 0.2


def test_large_shift_via_pyramid():
    img = _smooth_texture(160, 200, seed=3)
    img2 = ndimage.shift(img, (0, 14.0), order=3, mode="nearest")
    pts = np.random.default_rng(4).uniform([40, 40], [150, 110], (40, 2)).astype(np.float32)
    p1, ok = t_flow.lk_track(
        torch.tensor(img), torch.tensor(img2), torch.tensor(pts),
        torch.ones(40, dtype=torch.bool), levels=4,
    )
    ok = ok.numpy()
    flow = p1.numpy()[ok] - pts[ok]
    assert (np.abs(flow[:, 0] - 14.0) < 0.5).mean() > 0.7


def test_matches_shifted_keypoints():
    img = _smooth_texture(120, 160, seed=5)
    img2 = ndimage.shift(img, (0, 5.0), order=3, mode="nearest")
    xy0 = np.random.default_rng(6).uniform([20, 20], [130, 95], (64, 2)).astype(np.float32)
    xy1 = (xy0 + [5.0, 0.0]).astype(np.float32)  # true correspondents
    ones = torch.ones(64, dtype=torch.bool)
    m = t_flow.flow_match_pair(
        torch.tensor(img), torch.tensor(img2), torch.tensor(xy0), ones, torch.tensor(xy1), ones,
        radius=2.0, max_matches=64,
    )
    v = m.valid.numpy()
    assert v.sum() > 40
    assert (m.idx_a.numpy()[v] == m.idx_b.numpy()[v]).mean() > 0.9  # identity correspondence
