"""Parity of the port's guided bridge registration (sfm_danpipeline_torch.
pipeline.guided) and guided-block realign (pipeline/merge.block_realign)
with the JAX reference.

  - guided_bridge_register: the three synthetic cases of tests/test_guided.py
    (a clean edge; 60% wrong edge matches with a 1.5 degree rotation error;
    no support) through both packages, both drawing the PnP RANSAC
    samples from the reference test's key. Acceptance, basin, anchored counts
    and support are held equal; the pose to 1e-3 rad / 1e-3 (float32
    Gauss-Newton after RANSAC), and the committed observations equal.
  - block_realign: a reconstruction whose block of views {3, 4, 5} carries a
    known Sim(3) error (the block's own cameras and points moved together,
    so it is internally consistent), both packages drawing the Sim(3)
    samples from one key: the same stats, the block's cameras back on the truth, the
    same fused tracks.
  - a small guided_enable=True pipeline run: the same registered views and
    guided registrations as the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_danpipeline_tpu.pipeline import merge as j_merge
from sfm_danpipeline_torch import interop
from sfm_danpipeline_torch.config import PipelineConfig
from sfm_danpipeline_torch.ops import prng
from sfm_danpipeline_torch.ops.lie import exp_so3
from sfm_danpipeline_torch.pipeline import merge as t_merge
from sfm_danpipeline_torch.pipeline.guided import _nanmedian, guided_bridge_register
from test_guided import _make_setup, _pose_err, _run
from torch_testing import one_torch_thread  # noqa: F401
from torch_v6_reference import STATE_FIELDS

GUIDED_KEY = 3  # the reference test's key (tests/test_guided.py _run)


def _state_np(st):
    return {k: np.asarray(getattr(st, k)) for k in STATE_FIELDS}


def _run_port(setup, cfg=None):
    (
        state, new_view, d_star, R_dn, t_dn, sweep, kp_xy, desc,
        kp_valid, colors, ft_a, ft_b, vt, K, s_true, poses, dv,
    ) = setup
    cfg = cfg or PipelineConfig()
    t = torch.as_tensor
    return guided_bridge_register(
        interop.key_from_numpy(jax.random.key_data(jax.random.key(GUIDED_KEY))),
        interop.state_from_numpy(_state_np(state)), new_view,
        [int(v) for v in dv if v >= 0], d_star, t(R_dn), t(t_dn), t(sweep), t(kp_xy), t(desc),
        t(kp_valid), t(colors), t(ft_a), t(ft_b), t(vt), t(K, dtype=torch.float32),
        torch.zeros(5), 640.0, (480, 640), 1.5, cfg,
    )


def _setups():
    """The three cases of tests/test_guided.py, with their expectations."""
    clean = _make_setup(np.random.default_rng(0))
    corrupt = _make_setup(np.random.default_rng(1), corrupt_frac=0.6, rot_err_deg=1.5)
    lst = list(_make_setup(np.random.default_rng(2), corrupt_frac=1.0))
    R_dn = np.asarray(lst[3]).copy()
    from sfm_danpipeline_tpu.ops.lie import exp_so3 as j_exp

    R_dn[0] = np.asarray(j_exp(jnp.asarray([1.7, 0.0, 1.1], jnp.float32))) @ R_dn[0]
    lst[3] = R_dn
    return {"clean": (clean, True), "corrupt": (corrupt, True), "no_support": (tuple(lst), False)}


@pytest.fixture(scope="module")
def guided_cases():
    out = {}
    for name, (setup, expect_ok) in _setups().items():
        sj, stats_j = _run(setup)
        st, stats_t = _run_port(setup)
        out[name] = (setup, expect_ok, sj, stats_j, st, stats_t)
    return out


@pytest.mark.parametrize("name", ["clean", "corrupt", "no_support"])
def test_guided_register_matches_reference(guided_cases, name):
    setup, expect_ok, sj, j, st, t = guided_cases[name]
    assert bool(j[0]) == t["ok"] == expect_ok, (j, t)
    assert [int(j[5]), int(j[6])] == t["n_anchored"]
    assert int(j[7]) == t["basin"]
    assert abs(j[8] - int(1000.0 * t["scale"])) <= 1, (j[8], t["scale"])
    assert int(j[9]) == t["votes"]
    assert int(j[2]) == t["n_support"]
    assert abs(int(j[1]) - t["n_inliers"]) <= 2, (j[1], t["n_inliers"])
    new_view = setup[1]
    if not expect_ok:
        assert not bool(st.camera_valid[new_view])
        assert torch.equal(st.track_feat, torch.as_tensor(np.asarray(setup[0].track_feat)))
        return
    ang_j, dc_j = _pose_err(sj, new_view, setup[15])
    cam_t = st.cameras[new_view].numpy()
    cam_j = np.asarray(sj.cameras[new_view])
    np.testing.assert_allclose(cam_t, cam_j, atol=1e-3)
    R_gt, t_gt = setup[15][new_view]
    R = exp_so3(torch.as_tensor(cam_t[:3])).numpy()
    ang_t = np.degrees(np.arccos(np.clip((np.trace(R @ R_gt.T) - 1) / 2, -1, 1)))
    assert ang_t < (0.5 if name == "clean" else 1.0) and abs(ang_t - ang_j) < 0.05
    tf_t, tf_j = st.track_feat.numpy(), np.asarray(sj.track_feat)
    assert int((tf_t[:, new_view] >= 0).sum()) == int((tf_j[:, new_view] >= 0).sum())
    assert (tf_t[:, new_view] >= 0).sum() >= 50 or name != "clean"
    assert t["n_obs"] == int(np.sum((tf_j >= 0) & np.asarray(sj.points_valid)[:, None] & np.asarray(sj.camera_valid)[None, :]))


def test_nanmedian_is_the_linear_quantile():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 5, 6):
        x = np.full(9, np.nan, np.float32)
        x[:n] = rng.normal(size=n).astype(np.float32)
        rng.shuffle(x)
        got = float(_nanmedian(torch.as_tensor(x)))
        want = float(jnp.nanmedian(jnp.asarray(x)))
        assert (np.isnan(got) and np.isnan(want)) or got == want, (n, got, want)


# ---------------------------------------------------------------------------
# block_realign
# ---------------------------------------------------------------------------

A_BLOCK, B_BLOCK = (0, 1, 2), (3, 4, 5)
SIM_ERR = dict(s=1.15, aa=np.array([0.02, -0.05, 0.03]), t=np.array([0.2, -0.1, 0.3]))
REALIGN_KEY = 7


def _block_case():
    """The guided test's registered 6-view map, re-tracked: points 0-149
    become one A-only track (views 0-2) and one B-only track (views 3-5)
    each, points 150-299 one track over all six views; match tables link
    every A view to every B view. Then the B block (its cameras and its
    B-only points) moves by SIM_ERR, which keeps it internally consistent
    and misplaces it against A."""
    from sfm_danpipeline_tpu.ops.lie import exp_so3 as j_exp
    from sfm_danpipeline_tpu.ops.lie import log_so3 as j_log

    setup = _make_setup(np.random.default_rng(4))
    state, kp_xy, K = setup[0], setup[6], setup[13]
    st = _state_np(state)
    V = st["cameras"].shape[0]
    n_split, n_pts = 150, 300
    tf = np.full_like(st["track_feat"], -1)
    tf[:n_split, list(A_BLOCK)] = st["track_feat"][:n_split, list(A_BLOCK)]
    tf[n_pts:n_pts + n_split, list(B_BLOCK)] = st["track_feat"][:n_split, list(B_BLOCK)]
    tf[n_split:n_pts] = st["track_feat"][n_split:n_pts]
    xyz = st["points_xyz"].copy()
    xyz[n_pts:n_pts + n_split] = xyz[:n_split]
    valid = (tf >= 0).sum(1) >= 2
    f2p = np.full_like(st["feat_to_point"], -1)
    for p, v in zip(*np.nonzero(tf >= 0)):
        f2p[v, tf[p, v]] = p
    truth = st["cameras"].copy()
    # The error: X' = s R X + t on the block's side.
    R = np.asarray(j_exp(jnp.asarray(SIM_ERR["aa"], jnp.float32)), np.float64)
    s, tv = SIM_ERR["s"], SIM_ERR["t"]
    cams = truth.copy()
    for v in B_BLOCK:
        Rc = np.asarray(j_exp(jnp.asarray(truth[v, :3])), np.float64)
        R_new = Rc @ R.T
        cams[v, :3] = np.asarray(j_log(jnp.asarray(R_new, jnp.float32)))
        cams[v, 3:] = s * truth[v, 3:] - R_new @ tv
    b_only = np.zeros(len(xyz), bool)
    b_only[n_pts:n_pts + n_split] = True
    xyz[b_only] = s * xyz[b_only] @ R.T + tv
    st = dict(
        st, track_feat=tf.astype(np.int32), feat_to_point=f2p.astype(np.int32),
        points_valid=valid, points_xyz=xyz.astype(np.float32), cameras=cams.astype(np.float32),
        n_points=np.asarray(n_pts + n_split, np.int32),
    )
    M = 256
    ft_a = np.zeros((V, V, M), np.int32)
    ft_b = np.zeros((V, V, M), np.int32)
    vt = np.zeros((V, V, M), bool)
    feats = np.asarray(setup[0].track_feat)
    for a in A_BLOCK:
        for b in B_BLOCK:
            rows = [p for p in range(n_pts) if feats[p, a] >= 0 and feats[p, b] >= 0][:M]
            ft_a[a, b, : len(rows)] = feats[rows, a]
            ft_b[a, b, : len(rows)] = feats[rows, b]
            vt[a, b, : len(rows)] = True
    b_mask = np.zeros(V, bool)
    b_mask[list(B_BLOCK)] = True
    K_cur = np.array([[float(st["focal"]), 0, K[0, 2]], [0, float(st["focal"]), K[1, 2]], [0, 0, 1]], np.float32)
    return st, truth, b_mask, ft_a, ft_b, vt, np.asarray(kp_xy), K_cur


@pytest.fixture(scope="module")
def realign_runs():
    st, truth, b_mask, ft_a, ft_b, vt, kp_xy, K = _block_case()
    key = jax.random.key(REALIGN_KEY)
    from sfm_danpipeline_tpu.pipeline.tracks import ReconstructionState as JState

    js = JState(**{k: jnp.asarray(v) for k, v in st.items()})
    sj, stats_j = j_merge.block_realign(
        key, js, jnp.asarray(b_mask), jnp.asarray(ft_a), jnp.asarray(ft_b), jnp.asarray(vt),
        jnp.asarray(kp_xy), jnp.asarray(K), threshold_px=6.0, n_hypotheses=4096,
    )
    t = torch.as_tensor
    st_t, stats_t = t_merge.block_realign(
        interop.key_from_numpy(jax.random.key_data(key)), interop.state_from_numpy(st), t(b_mask),
        t(ft_a), t(ft_b), t(vt), t(kp_xy), t(K), threshold_px=6.0, n_hypotheses=4096,
    )
    return truth, sj, np.asarray(stats_j), st_t, stats_t


def test_block_realign_matches_reference(realign_runs):
    truth, sj, j, st, t = realign_runs
    assert bool(j[0]) and t["ok"]
    assert int(j[1]) == t["n_inliers"] and int(j[2]) == t["n_candidates"]
    assert abs(int(j[3]) - int(1000.0 * t["scale"])) <= 1, (j[3], t["scale"])
    np.testing.assert_array_equal(st.track_feat.numpy(), np.asarray(sj.track_feat))
    np.testing.assert_array_equal(st.points_valid.numpy(), np.asarray(sj.points_valid))
    np.testing.assert_array_equal(st.feat_to_point.numpy(), np.asarray(sj.feat_to_point))
    np.testing.assert_allclose(st.cameras.numpy(), np.asarray(sj.cameras), atol=1e-4)
    live = st.points_valid.numpy()
    np.testing.assert_allclose(
        st.points_xyz.numpy()[live], np.asarray(sj.points_xyz)[live], atol=1e-3
    )


def test_block_realign_undoes_the_error(realign_runs):
    truth, _, _, st, t = realign_runs
    # The correction is the error's inverse: scale 1 / 1.15.
    assert abs(t["scale"] * SIM_ERR["s"] - 1.0) < 1e-2
    C = lambda cams: -np.einsum("vij,vi->vj", exp_so3(torch.as_tensor(cams[:, :3])).numpy(), cams[:, 3:])  # noqa: E731
    np.testing.assert_allclose(C(st.cameras.numpy())[list(B_BLOCK)], C(truth)[list(B_BLOCK)], atol=2e-2)
    # Every fused B-only track joined its A-only partner.
    assert int(st.points_valid.sum()) < int(t["n_candidates"]) + 300


def test_block_realign_without_candidates_changes_nothing():
    st, _, b_mask, ft_a, ft_b, vt, kp_xy, K = _block_case()
    t = torch.as_tensor
    state = interop.state_from_numpy(st)
    out, stats = t_merge.block_realign(
        prng.key(0), state, t(b_mask), t(ft_a), t(ft_b), t(np.zeros_like(vt)),
        t(kp_xy), t(K), threshold_px=6.0, n_hypotheses=256,
    )
    assert stats["n_candidates"] > 0  # the cross tracks remain
    out, stats = t_merge.block_realign(
        prng.key(0), state, t(np.zeros_like(b_mask)), t(ft_a), t(ft_b), t(vt),
        t(kp_xy), t(K), threshold_px=6.0, n_hypotheses=256,
    )
    assert not stats["ok"] and stats["n_candidates"] == 0 and out is state


# ---------------------------------------------------------------------------
# The pipeline with guided bridging on
# ---------------------------------------------------------------------------

# The V=6 test scene with a PnP acceptance bar of 54 inliers (from the third
# registered view on): plain PnP registers view 5 with 53 inliers and fails,
# and the guided bridge registers it with 55, in both packages (my CPU runs;
# the margin is one or two inliers either way).
GUIDED_PIPE = dict(pnp_min_inliers=54, guided_min_done=3)


@pytest.fixture(scope="module")
def guided_pipelines():
    from sfm_danpipeline_tpu.config import FeatureConfig as JFeatureConfig
    from sfm_danpipeline_tpu.config import PipelineConfig as JPipelineConfig
    from sfm_danpipeline_tpu.pipeline.sfm import SfMPipeline as JPipeline
    from sfm_danpipeline_torch.config import FeatureConfig
    from sfm_danpipeline_torch.pipeline import sfm as t_sfm
    from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene
    from torch_v6_reference import V6_MAX_KEYPOINTS, V6_SCENE

    scene = make_courtyard_scene(**V6_SCENE)

    def cfg(pc, fc):
        c = pc(features=fc(max_keypoints=V6_MAX_KEYPOINTS))
        return dataclasses.replace(
            c, geometry=dataclasses.replace(c.geometry, guided_enable=True, **GUIDED_PIPE)
        )

    ref = JPipeline(cfg(JPipelineConfig, JFeatureConfig)).run(scene.images, scene.intrinsics)
    attempts = []
    orig = t_sfm.guided_bridge_register

    def spy(*a, **kw):
        out = orig(*a, **kw)
        attempts.append((a[2], out[1]["ok"]))
        return out

    t_sfm.guided_bridge_register = spy
    try:
        port = t_sfm.SfMPipeline(cfg(PipelineConfig, FeatureConfig), device="cpu").run(
            scene.images, scene.intrinsics
        )
    finally:
        t_sfm.guided_bridge_register = orig
    return ref, port, attempts


def test_guided_pipeline_matches_reference(guided_pipelines):
    ref, port, attempts = guided_pipelines
    assert port.registered_views == sorted(ref.registered_views) == list(range(6))
    assert port.metrics["n_guided_registered"] == ref.metrics["n_guided_registered"] == 1
    assert attempts == [(5, True)]
    assert "block_realign_applied" not in port.metrics  # a block of one view: nothing to realign
    np.testing.assert_allclose(port.metrics["ba_rms_px"], ref.metrics["ba_rms_px"], rtol=1e-3)
    assert port.metrics["ba_rms_px"] < 1.0
