"""Parity of the port's Sim(3) estimation (sfm_danpipeline_torch.ops.
similarity) and component merge (pipeline/merge.py, the merge attempt of
pipeline/sfm.py) with the JAX reference.

The cases of tests/test_similarity.py run through both packages on the
same numpy inputs, RANSAC draws injected from the reference's key:
indices and masks must be equal and floats within 1e-5 (1e-4 where an
SVD of a noisy covariance sits in between). The merge attempt's Sim(3)
draws come from one key in both packages. The merge-attempt stage test
splits the reference's V=6 reconstruction into A = {0,1,2} and B = {3,4,5},
moves B by a known Sim(3), and runs both packages' merge attempts: both
must accept with the same stats and recover the scale within 1e-3; the
merged cameras agree within 1e-4 before the attempt's bundle adjustment
and within 1e-3 after it. The attempt's BA runs on both sides with the
budget and tolerance of MERGE_BA, so that each LM loop stops by its own
convergence test. With the defaults (8 iterations, rtol 1e-8, a relative
decrease below float32's resolution of the cost) the loop can only end on
its iteration cap or its damping cap, after steps accepted or rejected on
the cost's last bits: the merged state is already at its minimum, those
steps wander along a flat valley, and the two packages' cameras ended
7-12e-4 apart, the gap following the number of torch threads. Converged,
they agree within 3e-6 at 1-8 threads.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_danpipeline_tpu.ops import similarity as j_sim
from sfm_danpipeline_tpu.ops.ransac import sample_indices as j_sample
from sfm_danpipeline_tpu.pipeline import merge as j_merge
from sfm_danpipeline_torch import interop
from sfm_danpipeline_torch.ops import similarity as t_sim
from sfm_danpipeline_torch.ops.lie import exp_so3, log_so3
from sfm_danpipeline_torch.pipeline import merge as t_merge
from test_similarity import _random_sim3, _two_component_states
from torch_testing import one_torch_thread  # noqa: F401
from torch_v6_reference import STATE_FIELDS, reference_v6

# The merge attempt's BA in this file's configs: a budget and a relative
# decrease under which both packages' LM loops stop converged (see the
# module docstring).
MERGE_BA = dict(intermediate_iterations=50, rtol=1e-4)


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _state_np(st):
    return {k: np.asarray(getattr(st, k)) for k in STATE_FIELDS}


def _assert_states_equal(st_t, st_j, atol=1e-5):
    for k in STATE_FIELDS:
        a, b = getattr(st_t, k).numpy(), np.asarray(getattr(st_j, k))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("weighted", [False, True])
def test_umeyama_matches(weighted):
    rng = np.random.default_rng(1 if weighted else 0)
    sim = _random_sim3(rng)
    X = rng.normal(size=(50, 3)).astype(np.float32)
    Y = np.array(j_sim.apply_sim3(sim, jnp.asarray(X)))
    w = None
    if weighted:
        Y[:10] += (rng.normal(size=(10, 3)) * 50).astype(np.float32)
        w = np.r_[np.zeros(10), np.ones(40)].astype(np.float32)
    ej = j_sim.umeyama(jnp.asarray(X), jnp.asarray(Y), None if w is None else jnp.asarray(w))
    et = t_sim.umeyama(_t(X), _t(Y), None if w is None else _t(w))
    np.testing.assert_allclose(float(et.s), float(ej.s), rtol=1e-5)
    np.testing.assert_allclose(et.R.numpy(), np.asarray(ej.R), atol=1e-5)
    np.testing.assert_allclose(et.t.numpy(), np.asarray(ej.t), atol=1e-5)
    # Both recover the truth.
    np.testing.assert_allclose(et.R.numpy(), np.asarray(sim.R), atol=1e-3)


def test_apply_sim3_matches():
    rng = np.random.default_rng(5)
    sim = _random_sim3(rng)
    X = rng.normal(size=(7, 3)).astype(np.float32)
    st = interop.sim3_from_numpy({k: np.asarray(getattr(sim, k)) for k in ("s", "R", "t")})
    np.testing.assert_allclose(
        t_sim.apply_sim3(st, _t(X)).numpy(), np.asarray(j_sim.apply_sim3(sim, jnp.asarray(X))),
        atol=1e-5,
    )


@pytest.mark.parametrize("case", ["outliers", "thin_support"])
def test_sim3_ransac_matches_with_injected_samples(case):
    if case == "outliers":
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
    else:
        rng = np.random.default_rng(3)
        X = rng.normal(size=(64, 3)).astype(np.float32)
        Y = rng.normal(size=(64, 3)).astype(np.float32)
        valid = np.zeros(64, bool)
        valid[:5] = True
        # Structureless: every 3-point fit explains its own sample and
        # nothing else, so the MSAC scores tie and the chosen sample (not
        # its support count) depends on rounding.
        key, thr = jax.random.key(1), 0.01
    rj = j_sim.estimate_sim3_ransac(key, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(valid), threshold=thr)
    samples = _t(j_sample(key, jnp.asarray(valid), 2048, 3))
    rt = t_sim.estimate_sim3_ransac(None, _t(X), _t(Y), _t(valid), threshold=thr, samples=samples)
    assert bool(rt.ok) == bool(rj.ok)
    assert int(rt.n_inliers) == int(rj.n_inliers)
    if case == "outliers":
        np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
        assert bool(rt.ok) and int(rt.n_inliers) >= 100
        np.testing.assert_allclose(float(rt.sim.s), float(rj.sim.s), rtol=1e-5)
        np.testing.assert_allclose(rt.sim.R.numpy(), np.asarray(rj.sim.R), atol=1e-5)
        np.testing.assert_allclose(rt.sim.t.numpy(), np.asarray(rj.sim.t), atol=1e-4)
        np.testing.assert_allclose(float(rt.sim.s), float(sim.s), rtol=0.02)


def _two_states():
    a, b, sim = _two_component_states()
    return (
        a, b, sim,
        interop.state_from_numpy(_state_np(a)), interop.state_from_numpy(_state_np(b)),
        interop.sim3_from_numpy({k: np.asarray(getattr(sim, k)) for k in ("s", "R", "t")}),
    )


def test_merge_components_matches():
    a, b, sim, ta, tb, tsim = _two_states()
    pid = np.zeros(4, np.int32)
    fuse = np.zeros(4, bool)
    fuse[0] = True
    mj = j_merge.merge_components(a, b, sim, jnp.asarray(pid), jnp.asarray(pid), jnp.asarray(fuse))
    mt = t_merge.merge_components(ta, tb, tsim, _t(pid), _t(pid), _t(fuse))
    _assert_states_equal(mt, mj)
    assert int(mt.n_points) == 5
    assert int(mt.track_feat[0, 2]) == 0 and int(mt.track_feat[0, 3]) == 2


def test_merge_components_camera_projection_invariance():
    _, _, _, ta, tb, tsim = _two_states()
    none = torch.zeros(1, dtype=torch.bool)
    merged = t_merge.merge_components(ta, tb, tsim, none.long(), none.long(), none)
    for v in (2, 3):
        Rb, tb_ = exp_so3(tb.cameras[v, :3]), tb.cameras[v, 3:]
        Rm, tm = exp_so3(merged.cameras[v, :3]), merged.cameras[v, 3:]
        Xb = tb.points_xyz[1]
        pc_b = Rb @ Xb + tb_
        pc_m = Rm @ t_sim.apply_sim3(tsim, Xb) + tm
        np.testing.assert_allclose((pc_m / pc_m[2]).numpy(), (pc_b / pc_b[2]).numpy(), atol=1e-4)


def test_cross_component_pairs_matches():
    a, b, _, ta, tb, _ = _two_states()
    V, M = 4, 6
    ft = np.zeros((V, V, M), np.int32)
    vt = np.zeros((V, V, M), bool)
    ft[0, 2, :3] = np.arange(3)
    vt[0, 2, :3] = True
    # A duplicate candidate (same point pair through view 1 <-> view 3)
    # must be deduplicated identically.
    ft[1, 3, :2] = [1, 2]
    vt[1, 3, :2] = True
    outs_j = j_merge.cross_component_pairs(a, b, jnp.asarray(ft), jnp.asarray(ft), jnp.asarray(vt))
    outs_t = t_merge.cross_component_pairs(ta, tb, _t(ft), _t(ft), _t(vt))
    for name, oj, ot in zip(("Xa", "Xb", "pid_a", "pid_b", "view_a", "feat_a", "mask"), outs_j, outs_t):
        oj = np.asarray(oj)
        if oj.dtype.kind == "f":
            np.testing.assert_allclose(ot.numpy(), oj, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(ot.numpy(), oj, err_msg=name)
    assert int(outs_t[-1].sum()) >= 3


def test_views_reprojection_median_matches():
    ref = reference_v6()
    st = ref.state
    K = np.asarray(ref.scene.intrinsics.K, np.float32)
    views = np.array([False, True, True, False, True, False])
    pts = np.arange(st["points_valid"].shape[0]) % 3 != 0
    for pm in (None, pts):
        mj = j_merge.views_reprojection_median(
            ref.result.state, jnp.asarray(views), jnp.asarray(ref.keypoints_xy), jnp.asarray(K),
            points_mask=None if pm is None else jnp.asarray(pm),
        )
        mt = t_merge.views_reprojection_median(
            interop.state_from_numpy(st), _t(views), _t(ref.keypoints_xy), _t(K),
            points_mask=None if pm is None else _t(pm),
        )
        np.testing.assert_allclose(mt, float(mj), rtol=1e-5)


# ----------------------------------------------------------------------
# Merge-attempt stage test on the reference's V=6 reconstruction.
A_VIEWS, B_VIEWS = (0, 1, 2), (3, 4, 5)
S_B = 0.8  # B's frame: X_B = S_B R_B X_A + T_B
AA_B = np.array([0.10, -0.25, 0.05], np.float32)
T_B = np.array([0.3, -0.2, 0.5], np.float32)


def _keep_views(st, keep):
    """The state restricted to views `keep` (points left with < 2
    observations invalidated)."""
    V = st["cameras"].shape[0]
    m = np.zeros(V, bool)
    m[list(keep)] = True
    tf = np.where(m[None, :], st["track_feat"], -1)
    pv = st["points_valid"] & ((tf >= 0).sum(1) >= 2)
    tf = np.where(pv[:, None], tf, -1)
    f2p = np.where(m[:, None], st["feat_to_point"], -1)
    f2p = np.where((f2p >= 0) & pv[np.clip(f2p, 0, None)], f2p, -1).astype(np.int32)
    return dict(st, track_feat=tf.astype(np.int32), points_valid=pv, feat_to_point=f2p,
                camera_valid=st["camera_valid"] & m)


def _move(st):
    """Express the state in B's frame."""
    R = exp_so3(torch.tensor(AA_B)).numpy()
    Rc = exp_so3(torch.tensor(st["cameras"][:, :3])).numpy()
    R_new = Rc @ R.T
    t_new = S_B * st["cameras"][:, 3:] - np.einsum("vij,j->vi", R_new, T_B)
    cams = np.concatenate([log_so3(torch.tensor(R_new)).numpy(), t_new], -1).astype(np.float32)
    xyz = (S_B * st["points_xyz"] @ R.T + T_B).astype(np.float32)
    return dict(st, cameras=cams, points_xyz=xyz)


@pytest.fixture(scope="module")
def merge_runs():
    from sfm_danpipeline_tpu.ops.similarity import estimate_sim3_reproj_ransac
    from sfm_danpipeline_tpu.pipeline.sfm import _bucket, _merge_attempt_step
    from sfm_danpipeline_tpu.pipeline.tracks import ReconstructionState as JState

    from sfm_danpipeline_torch.config import FeatureConfig, PipelineConfig
    from sfm_danpipeline_torch.pipeline.incremental import MatchTables
    from sfm_danpipeline_torch.pipeline.sfm import SetInputs, merge_attempt_step

    ref = reference_v6()
    cfg = dataclasses.replace(
        ref.config,
        ba=dataclasses.replace(ref.config.ba, **MERGE_BA),
    )
    st_a = _keep_views(ref.state, A_VIEWS)
    st_b = _move(_keep_views(ref.state, B_VIEWS))
    ja, jb = JState(**{k: jnp.asarray(v) for k, v in st_a.items()}), JState(**{k: jnp.asarray(v) for k, v in st_b.items()})
    intr = ref.scene.intrinsics
    V = len(A_VIEWS) + len(B_VIEWS)
    K = np.asarray(intr.K, np.float32)
    dist = np.asarray(intr.dist, np.float32)
    pp = np.array([intr.cx, intr.cy], np.float32)
    ft_a, ft_b, vt = ref.tables
    b_mask = np.zeros(V, bool)
    b_mask[list(B_VIEWS)] = True
    dv_a = np.full(V, -1, np.int32)
    dv_a[: len(A_VIEWS)] = A_VIEWS
    fixv = np.zeros(V, bool)
    fixv[A_VIEWS[0]] = True
    n_pts = 2 * int(st_a["n_points"])
    n_obs = int((st_a["track_feat"] >= 0).sum() + (st_b["track_feat"] >= 0).sum())
    n_bucket = _bucket(int(1.3 * n_pts) + 256, cfg.max_points)
    need = max(1024, int(1.5 * n_obs) + 4096)
    n_obs_bucket = min(1 << (need - 1).bit_length(), n_bucket * V)
    key = jax.random.key(11)
    j_state, j_stats = _merge_attempt_step(
        key, ja, jb, jnp.asarray(b_mask), jnp.asarray(dv_a), jnp.asarray(ft_a), jnp.asarray(ft_b),
        jnp.asarray(vt), jnp.asarray(ref.keypoints_xy), jnp.asarray(ref.colors), jnp.asarray(pp),
        jnp.asarray(K), jnp.asarray(dist), jnp.asarray(fixv), cfg, n_bucket, n_obs_bucket,
        not cfg.ba.optimize_focal, float(cfg.geometry.max_reprojection_error_px),
    )
    # The reference's Sim(3) and draws, recomputed outside the fused step.
    Xa, Xb, _, _, va, fa, m = j_merge.cross_component_pairs(ja, jb, jnp.asarray(ft_a), jnp.asarray(ft_b), jnp.asarray(vt))
    K_cur = jnp.asarray([[ja.focal, 0.0, pp[0]], [0.0, ja.focal, pp[1]], [0.0, 0.0, 1.0]])
    j_simres = estimate_sim3_reproj_ransac(
        key, Xb, Xa, ja.cameras[va], jnp.asarray(ref.keypoints_xy)[va, fa], K_cur, m,
        threshold_px=0.75 * cfg.geometry.max_merge_reprojection_px, n_hypotheses=16384, min_inliers=8,
    )
    # Both packages' merged geometry before the attempt's triangulation and
    # BA, each with its own Sim(3) estimate from the same key.
    tkey = interop.key_from_numpy(jax.random.key_data(key))
    ta, tb = interop.state_from_numpy(st_a), interop.state_from_numpy(st_b)
    o = t_merge.cross_component_pairs(ta, tb, *(_t(a) for a in ref.tables))
    t_simres = t_sim.estimate_sim3_reproj_ransac(
        tkey, o[1], o[0], ta.cameras[o[4]], _t(ref.keypoints_xy)[o[4], o[5]], _t(K_cur), o[6],
        threshold_px=0.75 * cfg.geometry.max_merge_reprojection_px, n_hypotheses=16384,
        min_inliers=8,
    )
    _, _, pid_a, pid_b, _, _, _ = j_merge.cross_component_pairs(
        ja, jb, jnp.asarray(ft_a), jnp.asarray(ft_b), jnp.asarray(vt)
    )
    premerge = (
        j_merge.merge_components(ja, jb, j_simres.sim, pid_a, pid_b, j_simres.inliers),
        t_merge.merge_components(ta, tb, t_simres.sim, o[2], o[3], t_simres.inliers),
    )
    tcfg = PipelineConfig(features=FeatureConfig(max_keypoints=cfg.features.max_keypoints))
    tcfg = dataclasses.replace(
        tcfg, ba=dataclasses.replace(tcfg.ba, **MERGE_BA)
    )
    inputs = SetInputs(
        config=tcfg, kp=SimpleNamespace(xy=_t(ref.keypoints_xy)), colors=_t(ref.colors), K=_t(K),
        dist=_t(dist), pp=_t(pp), max_dim=float(max(ref.scene.images.shape)),
        tables=MatchTables(*(_t(a) for a in ref.tables), None),
    )
    t_state, t_stats = merge_attempt_step(
        tkey, interop.state_from_numpy(st_a), interop.state_from_numpy(st_b), B_VIEWS, A_VIEWS,
        inputs, _t(fixv),
    )
    return dict(
        j_state=j_state, j_stats=np.asarray(j_stats), j_sim=j_simres, t_state=t_state,
        t_stats=t_stats, premerge=premerge,
    )


def test_merge_attempt_accepts_with_same_stats(merge_runs):
    j = merge_runs["j_stats"]
    t = merge_runs["t_stats"]
    assert bool(j[0]) and t["accepted"], (j, t)
    assert bool(j[1]) == t["sim_ok"]
    assert int(j[2]) == t["n_sim_inliers"]
    # Medians in px (the reference reports int(1000 * px)).
    assert abs(t["med_gate1_px"] - j[3] / 1000.0) <= 2e-3, (t["med_gate1_px"], j[3])
    assert abs(t["med_gate2_px"] - j[4] / 1000.0) <= 2e-3, (t["med_gate2_px"], j[4])
    assert int(j[5]) == t["n_cross_tracks"] and t["n_cross_tracks"] >= 20


def test_merge_attempt_recovers_scale(merge_runs):
    s_j = float(merge_runs["j_sim"].sim.s)
    s_t = merge_runs["t_stats"]["scale"]
    assert abs(s_j * S_B - 1.0) < 1e-3, s_j
    assert abs(s_t * S_B - 1.0) < 1e-3, s_t


def test_merge_attempt_merged_cameras_equal(merge_runs):
    mj, mt = merge_runs["premerge"]
    _assert_states_equal(mt, mj, atol=1e-4)
    cj = np.asarray(merge_runs["j_state"].cameras)
    ct = merge_runs["t_state"].cameras.numpy()
    np.testing.assert_allclose(ct, cj, atol=1e-3)
    assert bool(merge_runs["t_state"].camera_valid.all())
    np.testing.assert_array_equal(
        merge_runs["t_state"].points_valid.numpy(), np.asarray(merge_runs["j_state"].points_valid)
    )
