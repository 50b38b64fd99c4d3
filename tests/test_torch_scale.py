"""Torch twins of the reference's two scale tests, which feed synthetic
keypoints and matches below the feature stage into the pipeline's own
methods (`_try_seed`, `_grow_component`, `_run_global_ba`,
`_rotavg_initialize`):

- tests/test_scaling.py: an open 32-view arc around a point ball, every
  view must register and the trajectory error stay under 2% of the
  diameter;
- tests/test_ring_closure.py: a closed 36-view ring, registered, then its
  poses warped by an injected drift of 40 degrees along the chain; three
  plain global BAs stay above 2% of the diameter, the rotation-averaging
  reinit (fed by the batched `score_pairs`) brings it under 2%.

The scenes are the reference tests' own constructions (the same rng draws
at the full size, which the slow twins check against the reference
module's scene functions). The full twins are `slow`, as the reference's are;
the unmarked ones hold the same gates on fewer views: a 12-view arc over
the same 234 degrees, and a 24-view ring of 1,500 points with visibility
sectors widened to +-40 degrees, so each view still shares points with a
few neighbours (the reference's own test passes at that size too: rotavg
ATE 0.035% of the diameter, plain LM 4.0%, measured on a CPU). At the full
36 views the reference's test misses its own rotavg gate on this tree
(ATE 3.05% of the diameter, plain LM 5.3%, measured on a CPU), and so does
the port's twin; PERF.md records both.
The port runs on the CPU and draws its RANSAC samples from the reference
tests' own keys (`split(key(seed), V * 32)` for registration, `key(99)` for
the ring's pair scoring).
"""
import dataclasses

import numpy as np
import pytest
import torch

from sfm_danpipeline_torch.config import FeatureConfig, PipelineConfig
from sfm_danpipeline_torch.ops import prng
from sfm_danpipeline_torch.ops.lie import exp_so3, log_so3
from sfm_danpipeline_torch.ops.matching import PairMatches
from sfm_danpipeline_torch.ops.sift import Keypoints
from sfm_danpipeline_torch.pipeline.bootstrap import score_pairs
from sfm_danpipeline_torch.pipeline.incremental import build_match_tables
from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline
from sfm_danpipeline_torch.pipeline.tracks import prune_observations, retriangulate_points
from sfm_danpipeline_torch.utils.metrics import aligned_rmse, camera_centers
from torch_testing import one_torch_thread  # noqa: F401


def _cameras_and_views(rng, pts, angles, height, sector_deg, kmax, noise_px):
    """World->camera poses on a circle of radius 8 looking at the origin,
    and each view's keypoints: the points within `sector_deg` of its
    azimuth (the reference tests' visibility model)."""
    az = np.arctan2(pts[:, 0], pts[:, 2])
    V = len(angles)
    R_all, t_all, feat_of = [], [], []
    kp_xy = np.zeros((V, kmax, 2), np.float32)
    kp_valid = np.zeros((V, kmax), bool)
    for v, ang in enumerate(angles):
        c = 8.0 * np.array([np.sin(ang), 0.0, np.cos(ang)])
        c[1] = height(ang)
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        t = -R @ c
        vis = np.abs(np.angle(np.exp(1j * (az - ang)))) < np.radians(sector_deg)
        ids = np.where(vis)[0][:kmax]
        cam = pts[ids] @ R.T + t
        px = cam[:, :2] / cam[:, 2:3] * [800, 800] + [320, 240] + rng.normal(0, noise_px, (len(ids), 2))
        fmap = np.full(len(pts), -1, np.int64)
        fmap[ids] = np.arange(len(ids))
        kp_xy[v, : len(ids)] = px
        kp_valid[v, : len(ids)] = True
        R_all.append(R)
        t_all.append(t)
        feat_of.append(fmap)
    return np.stack(R_all), np.stack(t_all), kp_xy, kp_valid, feat_of


def _ball(rng, n_pts, radius):
    pts = rng.uniform(-1.0, 1.0, (n_pts, 3))
    pts /= np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1.0)
    return pts * (radius * rng.uniform(0.3, 1.0, (n_pts, 1)))


def arc_scene(rng, V, n_pts=1400, kmax=512):
    """tests/test_scaling.py's open arc (234 degrees, 130-degree sectors)."""
    pts = _ball(rng, n_pts, 1.0)
    angles = [(v / V) * 1.3 * np.pi - 0.65 * np.pi for v in range(V)]
    return (pts,) + _cameras_and_views(rng, pts, angles, lambda a: 0.5 * np.sin(3 * a), 65.0, kmax, 0.3)


def ring_scene(rng, V, n_pts=2200, kmax=384, sector_deg=30.0):
    """tests/test_ring_closure.py's closed ring (ball radius 2.5)."""
    pts = _ball(rng, n_pts, 2.5)
    angles = [(v / V) * 2.0 * np.pi for v in range(V)]
    return (pts,) + _cameras_and_views(rng, pts, angles, lambda a: 0.4 * np.sin(2 * a), sector_deg, kmax, 0.5)


def _matches(rng, feat_of, m_slots, min_common):
    """Every pair sharing >= min_common points: up to m_slots shuffled
    common points, in the reference tests' order."""
    V = len(feat_of)
    pi, pj, ia, ib, mv = [], [], [], [], []
    for i in range(V - 1):
        for j in range(i + 1, V):
            common = np.where((feat_of[i] >= 0) & (feat_of[j] >= 0))[0]
            if len(common) < min_common:
                continue
            rng.shuffle(common)
            common = common[:m_slots]
            a = np.zeros(m_slots, np.int32)
            b = np.zeros(m_slots, np.int32)
            m = np.zeros(m_slots, bool)
            a[: len(common)] = feat_of[i][common]
            b[: len(common)] = feat_of[j][common]
            m[: len(common)] = True
            pi.append(i)
            pj.append(j)
            ia.append(a)
            ib.append(b)
            mv.append(m)
    z = torch.zeros((len(pi), m_slots))
    matches = PairMatches(
        idx_a=torch.tensor(np.stack(ia)), idx_b=torch.tensor(np.stack(ib)), dist=z, lowe=z,
        valid=torch.tensor(np.stack(mv)),
    )
    return np.asarray(pi), np.asarray(pj), matches


class _Intr:
    fx = 800.0


def _pipeline(kp_xy, kp_valid, matches, pi, pj, max_points, seed):
    """An SfMPipeline on the CPU with the context `run` would have built
    from these keypoints and matches (the reference tests' grow_args)."""
    V, kmax = kp_valid.shape
    cfg = dataclasses.replace(
        PipelineConfig(), features=FeatureConfig(max_keypoints=kmax), max_points=max_points
    )
    pipe = SfMPipeline(cfg, device="cpu")
    ones = torch.ones((V, kmax))
    kp = Keypoints(
        xy=torch.tensor(kp_xy), sigma=ones, angle=torch.zeros((V, kmax)), response=ones,
        descriptors=torch.zeros((V, kmax, 128)), valid=torch.tensor(kp_valid),
    )
    ft_a, ft_b, vt = build_match_tables(matches, pi, pj, V)
    pipe._keys = prng.split(prng.key(seed), V * 32)
    pipe._key_n = 0
    pipe._ctx = dict(
        tables=(ft_a, ft_b, vt, vt), kp=kp,
        colors=torch.zeros((V, kmax, 3)), pp=torch.tensor([320.0, 240.0]),
        K=torch.tensor([[800.0, 0, 320.0], [0, 800.0, 240.0], [0, 0, 1.0]]), dist=torch.zeros(5),
        max_dim=640.0, image_size=(480, 640),
    )
    pair_of = {(int(a), int(b)): n for n, (a, b) in enumerate(zip(pi, pj))}
    return pipe, pair_of


def _ate_frac(state, R_all, t_all):
    C_gt = -np.einsum("vij,vi->vj", R_all, t_all)
    diam = np.linalg.norm(C_gt.max(0) - C_gt.min(0))
    return aligned_rmse(camera_centers(state.cameras.numpy()), C_gt) / diam


def _grow(pipe, pair_of, matches, seed_pairs):
    seed = pipe._try_seed(seed_pairs, set(), matches, pair_of, _Intr(), True)
    assert seed is not None, "synthetic seed failed"
    state, done, _ = seed
    state = pipe._grow_component(state, done, set(), anchor=0, run_ba_every_view=True)
    return state, done


def _arc_twin(V, n_pts):
    rng = np.random.default_rng(7)
    pts, R_all, t_all, kp_xy, kp_valid, feat_of = arc_scene(rng, V, n_pts)
    pi, pj, matches = _matches(rng, feat_of, 512, 0)
    pipe, pair_of = _pipeline(kp_xy, kp_valid, matches, pi, pj, 4096, seed=0)
    state, done = _grow(pipe, pair_of, matches, [(0, 2), (0, 1), (0, 4)])
    assert len(done) == V, f"only {len(done)}/{V} views registered"
    state, _ = pipe._run_global_ba(state, anchor=0)
    state, _ = pipe._run_global_ba(state, anchor=0)
    ate = _ate_frac(state, R_all, t_all)
    assert ate < 0.02, f"ATE {ate:.4%} of the diameter"


def _ring_twin(V, n_pts, sector_deg):
    rng = np.random.default_rng(11)
    pts, R_all, t_all, kp_xy, kp_valid, feat_of = ring_scene(rng, V, n_pts, sector_deg=sector_deg)
    pi, pj, matches = _matches(rng, feat_of, 384, 16)
    pipe, pair_of = _pipeline(kp_xy, kp_valid, matches, pi, pj, 8192, seed=3)
    state, done = _grow(pipe, pair_of, matches, [(0, 2), (0, 1), (0, 3)])
    assert len(done) == V, f"only {len(done)}/{V} ring views registered"
    c = pipe._ctx
    scores = score_pairs(
        prng.key(99), matches, c["kp"].xy, pi, pj, c["K"], c["dist"], 640.0,
        pipe.config,
    )
    # The reference test's injected drift: a world-side rotation warp that
    # grows along the chain to 40 degrees, points re-triangulated under the
    # drifted poses and the observations it breaks pruned.
    cams = state.cameras.numpy().astype(np.float64)
    axis = np.array([0.25, 1.0, 0.15])
    axis /= np.linalg.norm(axis)
    for v in range(V):
        T = exp_so3(torch.tensor(axis * np.radians(40.0) * v / V, dtype=torch.float32)).double().numpy()
        R_v = exp_so3(torch.tensor(cams[v, :3], dtype=torch.float32)).numpy()
        C_v = -R_v.T @ cams[v, 3:]
        R_d = R_v @ T.T
        cams[v, :3] = log_so3(torch.tensor(R_d, dtype=torch.float32)).numpy()
        cams[v, 3:] = -R_d @ (T @ C_v)
    f = float(state.focal)
    K_cur = torch.tensor([[f, 0.0, 320.0], [0.0, f, 240.0], [0.0, 0.0, 1.0]])
    drifted = retriangulate_points(
        dataclasses.replace(state, cameras=torch.tensor(cams, dtype=torch.float32)), c["kp"].xy, K_cur
    )
    drifted = prune_observations(drifted, c["kp"].xy, K_cur, max_error_px=6.0)
    st_plain = drifted
    for _ in range(3):
        st_plain, _ = pipe._run_global_ba(st_plain, anchor=0)
    st_avg = pipe._rotavg_initialize(
        drifted, done, scores, pi, pj, c["tables"], c["kp"].xy, c["colors"], c["pp"], c["K"], c["dist"]
    )
    st_avg, _ = pipe._run_global_ba(st_avg, anchor=0, intermediate=True)
    st_avg, _ = pipe._run_global_ba(st_avg, anchor=0)
    ate_plain, ate_avg = _ate_frac(st_plain, R_all, t_all), _ate_frac(st_avg, R_all, t_all)
    assert ate_avg < 0.02, f"rotavg-initialized ring ATE {ate_avg:.4%} (plain {ate_plain:.4%})"
    # The failure mode is real: plain LM from the drifted basin stays off.
    assert ate_plain > 0.02, f"drift injection too weak: plain LM reached {ate_plain:.4%}"


def _same_scene(ours, theirs):
    """Our scene's (pts, R, t, kp_xy, kp_valid, feat_of) against the
    reference test's (pts, K, R, t, kp_xy, kp_valid, feat_of)."""
    for x, y in zip(ours, (theirs[0],) + tuple(theirs[2:])):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_arc_registers_every_view_small():
    _arc_twin(V=12, n_pts=700)


def test_ring_closes_with_rotavg_small():
    _ring_twin(V=24, n_pts=1500, sector_deg=40.0)


@pytest.mark.slow
def test_synthetic_arc_full_registration_and_scaling():
    import test_scaling

    _same_scene(arc_scene(np.random.default_rng(7), 32), test_scaling._make_scene(np.random.default_rng(7)))
    _arc_twin(V=32, n_pts=1400)


@pytest.mark.slow
def test_ring_closes_with_rotavg_initializer():
    import test_ring_closure

    _same_scene(ring_scene(np.random.default_rng(11), 36), test_ring_closure._make_ring(np.random.default_rng(11)))
    _ring_twin(V=36, n_pts=2200, sector_deg=30.0)
