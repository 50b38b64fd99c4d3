"""Parity of the port's rotation and translation averaging
(sfm_danpipeline_torch.ops.rotavg) and of its rotation-averaging reinit
(`SfMPipeline._rotavg_initialize`) with the JAX reference.

The cases of tests/test_rotavg.py run through both packages. Rotations are
compared after the gauge fix R[0] = I (both packages apply it) within
1e-4 entrywise, chordal residuals within 1e-4; translation-averaged centers
up to sign and scale within 1e-4 (the raw eigenvectors are never
compared). The reinit runs on the reference's V=6 reconstruction and pair
scores, called directly whatever `rotavg_min_views` is; the cameras it
produces must agree within 1e-3 rad in rotation and 1e-3 relative in
center position.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_danpipeline_tpu.ops import rotavg as j_ra
from sfm_danpipeline_tpu.ops.lie import exp_so3 as j_exp
from sfm_danpipeline_torch import interop
from sfm_danpipeline_torch.ops import rotavg as t_ra
from sfm_danpipeline_torch.utils.metrics import camera_centers
from test_rotavg import _max_angle_err, _ring_problem
from torch_v6_reference import reference_v6
from torch_testing import one_torch_thread  # noqa: F401


def _t(a):
    return torch.tensor(np.asarray(a))


def _rot_angle(Ra, Rb):
    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def _ring(case):
    if case == "exact":
        R_gt, pi, pj, Rr = _ring_problem(8, 0.0, np.random.default_rng(0))
        w = np.ones(len(pi), np.float32)
    elif case == "drift":
        R_gt, pi, pj, Rr = _ring_problem(16, 0.05, np.random.default_rng(1))
        w = np.ones(len(pi), np.float32)
    else:  # a grossly wrong edge 0 -> 4, disabled (weight 0) or live
        R_gt, pi, pj, Rr = _ring_problem(8, 0.0, np.random.default_rng(2))
        bad = np.asarray(j_exp(jnp.asarray([1.5, 0.2, -0.9])))[None]
        pi = jnp.concatenate([pi, jnp.asarray([0], jnp.int32)])
        pj = jnp.concatenate([pj, jnp.asarray([4], jnp.int32)])
        Rr = jnp.concatenate([Rr, jnp.asarray(bad, jnp.float32)])
        w = np.r_[np.ones(len(pi) - 1), 0.0 if case == "bad_edge_off" else 1.0].astype(np.float32)
    return R_gt, np.asarray(pi), np.asarray(pj), np.asarray(Rr), w


@pytest.mark.parametrize("case", ["exact", "drift", "bad_edge_off", "bad_edge_on"])
def test_average_rotations_matches(case):
    R_gt, pi, pj, Rr, w = _ring(case)
    V = R_gt.shape[0]
    Rj, res_j = j_ra.average_rotations(jnp.asarray(pi), jnp.asarray(pj), jnp.asarray(Rr), jnp.asarray(w), V)
    Rt, res_t = t_ra.average_rotations(_t(pi), _t(pj), _t(Rr), _t(w), V)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j), atol=1e-4)
    if case in ("exact", "bad_edge_off"):
        assert _max_angle_err(Rt.numpy(), R_gt) < 2e-3
    if case == "bad_edge_on":
        assert _max_angle_err(Rt.numpy(), R_gt) > 0.05


def test_average_translations_matches():
    """Centers of a ring from noisy baseline directions of every view pair
    (a cycle alone does not fix the shape) under the true rotations, with
    one edge disabled."""
    rng = np.random.default_rng(4)
    V = 10
    R_gt = np.asarray(_ring_problem(V, 0.0, rng)[0])
    th = 2 * np.pi * np.arange(V) / V
    C = np.stack([np.cos(th), 0.1 * np.sin(3 * th), np.sin(th)], -1)
    pi, pj = (a.astype(np.int32) for a in np.triu_indices(V, 1))
    t_rel = []
    for i, j in zip(pi, pj):
        t_ij = -R_gt[j] @ (C[j] - C[i])  # x_j = R_ij x_i + t_ij, up to scale
        t_rel.append(t_ij / np.linalg.norm(t_ij) + rng.normal(0, 0.01, 3))
    t_rel = np.asarray(t_rel, np.float32)
    w = np.ones(len(pi), np.float32)
    w[3] = 0.0
    Cj, rj = j_ra.average_translations(
        jnp.asarray(pi), jnp.asarray(pj), jnp.asarray(R_gt), jnp.asarray(t_rel), jnp.asarray(w), V
    )
    Ct, rt = t_ra.average_translations(_t(pi), _t(pj), _t(R_gt), _t(t_rel), _t(w), V)
    Cj, Ct = np.asarray(Cj), Ct.numpy()
    sign = 1.0 if np.sum(Cj * Ct) >= 0 else -1.0
    np.testing.assert_allclose(sign * Ct, Cj, atol=1e-4)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-4)
    # Both recover the ring up to sign and scale.
    Cg = (C - C.mean(0)) / np.linalg.norm(C - C.mean(0))
    assert min(np.abs(Ct - Cg).max(), np.abs(Ct + Cg).max()) < 0.05


def test_project_so3_matches():
    M = np.random.default_rng(3).normal(size=(5, 3, 3)).astype(np.float32)
    Rj = np.asarray(j_ra.project_so3(jnp.asarray(M)))
    Rt = t_ra.project_so3(_t(M)).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)
    for r in Rt:
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
        assert np.linalg.det(r) > 0.99


def _pose_graph_scores(cams, pi, pj, seed=0):
    """Two-view scores of every pair from the cameras themselves, with
    0.3 deg rotation noise and 1% direction noise: the true relative pose
    sits in basin p % 2, a 25-deg-off decoy in the other."""
    from sfm_danpipeline_torch.ops.lie import exp_so3

    rng = np.random.default_rng(seed)
    R = exp_so3(torch.tensor(cams[:, :3])).numpy().astype(np.float64)
    t = cams[:, 3:].astype(np.float64)
    decoy = exp_so3(torch.tensor([0.0, np.radians(25.0), 0.0])).numpy()
    P = len(pi)
    R_rel = np.zeros((P, 2, 3, 3), np.float32)
    t_rel = np.zeros((P, 2, 3), np.float32)
    for p, (i, j) in enumerate(zip(pi, pj)):
        noise = exp_so3(torch.tensor(rng.normal(0, np.radians(0.3), 3), dtype=torch.float32)).numpy()
        Rij = noise @ R[j] @ R[i].T
        tij = t[j] - R[j] @ R[i].T @ t[i]
        tij = tij / np.linalg.norm(tij) + rng.normal(0, 0.01, 3)
        b = p % 2
        R_rel[p, b], R_rel[p, 1 - b] = Rij, decoy @ Rij
        t_rel[p, b], t_rel[p, 1 - b] = tij, tij
    n = np.full(P, 200, np.int32)
    return dict(
        pose_inlier_ratio=np.full(P, 0.9, np.float32), n_matches=n, usable=np.ones(P, bool),
        h_over_e=np.full(P, 0.5, np.float32), R_rel=R_rel, t_rel=t_rel,
        n_inliers=np.stack([n, n - 20], -1),
    )


def test_rotavg_initialize_matches_on_reference_state():
    """The reinit on the reference's V=6 reconstruction with a complete,
    slightly noisy pose graph (the arc's own two-view scores leave a
    graph too thin for the translation averaging to be well posed)."""
    from sfm_danpipeline_tpu.pipeline.bootstrap import PairScores as JScores
    from sfm_danpipeline_tpu.pipeline.sfm import SfMPipeline as JPipeline

    from sfm_danpipeline_torch.config import FeatureConfig, PipelineConfig
    from sfm_danpipeline_torch.ops.lie import exp_so3
    from sfm_danpipeline_torch.pipeline.incremental import MatchTables
    from sfm_danpipeline_torch.pipeline.sfm import SetInputs, SfMPipeline

    ref = reference_v6()
    cfg = ref.config
    intr = ref.scene.intrinsics
    K = np.asarray(intr.K, np.float32)
    dist = np.asarray(intr.dist, np.float32)
    pp = np.array([intr.cx, intr.cy], np.float32)
    scores = _pose_graph_scores(ref.state["cameras"], ref.pi, ref.pj)
    done = set(ref.result.registered_views)
    tables = tuple(jnp.asarray(a) for a in ref.tables) + (None,)
    st_j = JPipeline(cfg)._rotavg_initialize(
        ref.result.state, done, JScores(**{k: jnp.asarray(v) for k, v in scores.items()}),
        jnp.asarray(ref.pi), jnp.asarray(ref.pj), tables, ref.result.keypoints,
        jnp.asarray(ref.colors), jnp.asarray(pp), jnp.asarray(K), jnp.asarray(dist),
    )
    assert st_j is not ref.result.state  # the reinit ran
    tcfg = PipelineConfig(features=FeatureConfig(max_keypoints=cfg.features.max_keypoints))
    pipe = SfMPipeline(tcfg, device="cpu")
    pipe._inputs = SetInputs(
        config=tcfg, kp=SimpleNamespace(xy=_t(ref.keypoints_xy)), colors=_t(ref.colors), K=_t(K),
        dist=_t(dist), pp=_t(pp), max_dim=float(max(ref.scene.images.shape)),
        tables=MatchTables(*(_t(a) for a in ref.tables), None), scores=interop.scores_from_numpy(scores),
        pair_of={(int(a), int(b)): n for n, (a, b) in enumerate(zip(ref.pi, ref.pj))},
    )
    st_t = pipe._rotavg_initialize(interop.state_from_numpy(ref.state), done)
    cams_j, cams_t = np.asarray(st_j.cameras), st_t.cameras.numpy()
    regs = sorted(done)
    # Gauge fix: every rotation relative to view 0's.
    Rj = exp_so3(torch.tensor(cams_j[regs, :3])).numpy()
    Rt = exp_so3(torch.tensor(cams_t[regs, :3])).numpy()
    for a, b in zip(Rt @ Rt[0].T, Rj @ Rj[0].T):
        assert _rot_angle(a, b) < 1e-3
    Cj, Ct = camera_centers(cams_j)[regs], camera_centers(cams_t)[regs]
    scale = np.linalg.norm(Cj - Cj.mean(0))
    assert np.abs(Ct - Cj).max() <= 1e-3 * scale, (np.abs(Ct - Cj).max(), scale)
    # The retriangulation and the re-fuse sweep rebuild the same tracks.
    assert abs(int(st_t.n_points) - int(st_j.n_points)) <= 0.01 * int(st_j.n_points)
    np.testing.assert_array_equal(st_t.camera_valid.numpy(), np.asarray(st_j.camera_valid))
