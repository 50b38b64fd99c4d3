"""Bundle adjustment over an observation table with no live rows, and the
reinit's accept gate on a candidate whose table is empty, in both packages.

The reference pads its BA table to a bucket of zero-weight rows (its
`_bucket`), so with no live observation its cost is zero and no step moves a
parameter. The port builds the table with exactly the live rows; with none,
`run_ba` returns the problem's parameters after zero iterations at a zero
cost and never hands the empty batch to the Jacobian's vmap. `_accept_reinit`
then reads the same RMS and observation counts as the reference and takes
its decision. The states are three views of the synthetic scene
(tests/conftest.py `synthetic_scene`), built by the reference's track
table.
"""
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_danpipeline_tpu.ba.problem import BAProblem as JProblem
from sfm_danpipeline_tpu.ba.solver import run_ba as j_run_ba
from sfm_danpipeline_tpu.config import BAConfig as JBAConfig
from sfm_danpipeline_torch import interop
from sfm_danpipeline_torch.ba.problem import make_problem
from sfm_danpipeline_torch.ba.solver import run_ba
from sfm_danpipeline_torch.config import BAConfig, PipelineConfig
from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline, ba_step
from torch_testing import one_torch_thread  # noqa: F401


def _empty_problem(n_cams=3, n_pts=5):
    rng = np.random.default_rng(0)
    cams = rng.normal(0, 0.1, (n_cams, 6)).astype(np.float32)
    pts = rng.normal(0, 1.0, (n_pts, 3)).astype(np.float32) + np.array([0, 0, 8], np.float32)
    return cams, pts


def test_run_ba_on_an_empty_table_returns_its_input():
    cams, pts = _empty_problem()
    prob = make_problem(
        torch.tensor(cams), 500.0, torch.tensor(pts), torch.zeros(0, dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), torch.zeros((0, 2)), torch.zeros(0),
    )
    res = run_ba(prob, BAConfig(), max_iterations=50)
    assert res.iterations == 0
    assert float(res.initial_cost) == 0.0 and float(res.final_cost) == 0.0
    assert torch.equal(res.cameras, prob.cameras) and torch.equal(res.points, prob.points)
    assert torch.equal(res.focal, prob.focal)
    # The reference on its padded form of the same table: weight-0 rows, a
    # zero cost, and parameters no step moves.
    n_pad = 16
    j = j_run_ba(
        JProblem(
            cameras=jnp.asarray(cams), focal=jnp.asarray(500.0, jnp.float32), points=jnp.asarray(pts),
            obs_cam=jnp.zeros(n_pad, jnp.int32), obs_pt=jnp.zeros(n_pad, jnp.int32),
            obs_xy=jnp.zeros((n_pad, 2), jnp.float32), obs_w=jnp.zeros(n_pad, jnp.float32),
            fix_cam=jnp.zeros(len(cams), bool), fix_focal=jnp.asarray(False),
        ),
        JBAConfig(), max_iterations=jnp.asarray(50, jnp.int32),
    )
    assert float(j.initial_cost) == 0.0 and float(j.final_cost) == 0.0
    np.testing.assert_array_equal(np.asarray(j.cameras), cams)
    np.testing.assert_array_equal(np.asarray(j.points), pts)


def _three_views(sc):
    """A 3-view state of 60 points of the synthetic scene (tests/conftest.py),
    built by the reference's track table, 0.05 off the true points, and the
    keypoints and principal point of its observations."""
    from sfm_danpipeline_tpu.ops.lie import log_so3
    from sfm_danpipeline_tpu.pipeline import tracks as j_tr

    n = 60
    views = (0, 2, 4)
    sj = j_tr.init_state(3, n, 128, float(sc["K"][0, 0]))
    cams = [np.concatenate([np.asarray(log_so3(jnp.asarray(sc["R"][v]))), sc["t"][v]]) for v in views]
    sj = dataclasses.replace(sj, cameras=jnp.asarray(np.stack(cams), jnp.float32), camera_valid=jnp.ones(3, bool))
    feats = jnp.arange(n, dtype=jnp.int32)
    noisy = jnp.asarray((sc["points"][:n] + 0.05).astype(np.float32))
    for b in (1, 2):
        sj = j_tr.add_points(sj, noisy, jnp.zeros((n, 3)), 0, feats, b, feats, jnp.ones(n, bool))
    state = {f.name: np.asarray(getattr(sj, f.name)) for f in dataclasses.fields(sj)}
    kp_xy = np.stack([sc["obs"][v, :n] for v in views]).astype(np.float32)
    pp = sc["K"][[0, 1], [2, 2]].astype(np.float32)
    return state, kp_xy, pp


def _emptied(st: dict, how: str) -> dict:
    st = dict(st)
    if how == "points invalid":
        st["points_valid"] = np.zeros_like(st["points_valid"])
    else:  # every track cleared
        st["track_feat"] = np.full_like(st["track_feat"], -1)
    return st


@pytest.mark.parametrize("how", ["points invalid", "tracks cleared"])
def test_ba_step_on_an_empty_table_returns_its_input(synthetic_scene, how):
    st_np, kp_xy, pp = _three_views(synthetic_scene)
    state = interop.state_from_numpy(_emptied(st_np, how))
    fix = torch.zeros((state.n_views,), dtype=torch.bool)
    fix[0] = True
    for local_view in (None, 2):
        out, c0, c1, n_it, n_obs = ba_step(
            state, torch.tensor(kp_xy), torch.tensor(pp), fix, PipelineConfig(), 30, local_view=local_view
        )
        assert n_it == 0 and float(c0) == 0.0 and float(c1) == 0.0 and float(n_obs) == 0.0
        assert torch.equal(out.cameras, state.cameras) and torch.equal(out.points_xyz, state.points_xyz)
        assert torch.equal(out.focal, state.focal)


@pytest.mark.parametrize("how", ["points invalid", "tracks cleared"])
def test_accept_reinit_on_an_emptied_candidate_takes_the_references_decision(synthetic_scene, how):
    """The candidate's table is empty and the snapshot's is not: both
    packages polish the snapshot alone and revert (applied 0), with the same
    observation count and an RMS within 1e-3 px."""
    from sfm_danpipeline_tpu.config import PipelineConfig as JConfig
    from sfm_danpipeline_tpu.pipeline.sfm import SfMPipeline as JPipeline
    from sfm_danpipeline_tpu.pipeline.tracks import ReconstructionState as JState

    snap_np, kp_xy, pp = _three_views(synthetic_scene)
    cand_np = _emptied(snap_np, how)
    j_state = lambda st: JState(**{k: jnp.asarray(v) for k, v in st.items()})  # noqa: E731
    _, m_j, applied_j = JPipeline(JConfig())._accept_reinit(
        j_state(cand_np), j_state(snap_np), SimpleNamespace(xy=jnp.asarray(kp_xy)), jnp.asarray(pp), 0, "test",
    )
    pipe = SfMPipeline(PipelineConfig(), device="cpu")
    pipe._ctx = dict(kp=SimpleNamespace(xy=torch.tensor(kp_xy)), pp=torch.tensor(pp))
    _, m_t, applied_t = pipe._accept_reinit(
        interop.state_from_numpy(cand_np), interop.state_from_numpy(snap_np), 0, "test"
    )
    assert applied_t == applied_j == 0.0
    assert m_t["ba_n_obs"] == m_j["ba_n_obs"] > 0
    assert abs(m_t["ba_rms_px"] - m_j["ba_rms_px"]) < 1e-3
