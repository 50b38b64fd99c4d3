"""Parity of the port's track table (sfm_danpipeline_torch.pipeline.tracks)
and bundle adjustment (sfm_danpipeline_torch.ba) with the JAX reference,
moving state between the packages with sfm_danpipeline_torch.interop.

Tolerances: track tables are integer and must be equal; point positions
rtol 1e-5. BA final costs agree within 1e-4 relative (same model and
damping schedule, f32 sums in another order), and the port lands within
1% of the float64 scipy oracle `ba/reference.py`, the bound
tests/test_ba_independent.py holds the JAX solver to.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_danpipeline_torch.ba.reference import solve_reference_problem
from sfm_danpipeline_tpu.ba.solver import run_ba as j_run_ba
from sfm_danpipeline_tpu.config import BAConfig as JBAConfig
from sfm_danpipeline_tpu.pipeline import tracks as j_tr
from sfm_danpipeline_torch import interop
from sfm_danpipeline_torch.ba.solver import run_ba as t_run_ba
from sfm_danpipeline_torch.config import BAConfig
from sfm_danpipeline_torch.pipeline import tracks as t_tr

from test_ba import _problem_from_scene
from torch_testing import one_torch_thread  # noqa: F401

V, KMAX, CAP = 4, 64, 256


def _np_state(st):
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


def _assert_states_equal(sj, st, rtol=1e-5):
    a, b = _np_state(sj), interop.state_to_numpy(st)
    for k in a:
        if a[k].dtype.kind == "f":
            np.testing.assert_allclose(b[k], a[k], rtol=rtol, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def _candidates(rng, n, view_a, view_b, dup=True):
    fa = rng.integers(0, KMAX, n).astype(np.int32)
    fb = rng.integers(0, KMAX, n).astype(np.int32)
    if dup:  # repeated features: matches share an endpoint
        fb[n // 2 : n // 2 + 5] = fb[:5]
    xyz = rng.normal(size=(n, 3)).astype(np.float32) + np.array([0, 0, 5], np.float32)
    rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.2
    return xyz, rgb, view_a, fa, view_b, fb, mask


@pytest.fixture(scope="module")
def grown_states():
    """The same three add_points calls (fusion included) on both sides."""
    rng = np.random.default_rng(0)
    sj = j_tr.init_state(V, KMAX, CAP, 500.0)
    st = t_tr.init_state(V, KMAX, CAP, 500.0)
    for va, vb in ((0, 1), (1, 2), (2, 0)):
        xyz, rgb, a, fa, b, fb, mask = _candidates(rng, 48, va, vb)
        sj = j_tr.add_points(sj, jnp.asarray(xyz), jnp.asarray(rgb), a, jnp.asarray(fa), b, jnp.asarray(fb), jnp.asarray(mask))
        st = t_tr.add_points(st, torch.tensor(xyz), torch.tensor(rgb), a, torch.tensor(fa), b, torch.tensor(fb), torch.tensor(mask))
    return sj, st


def test_add_points_tables_match(grown_states):
    sj, st = grown_states
    _assert_states_equal(sj, st)
    tf = st.track_feat.numpy()
    assert int(st.n_points) > 48 and ((tf >= 0).sum(1) >= 3).any()  # fused tracks


def test_prune_and_find_2d3d_match(grown_states):
    sj, _ = grown_states
    rng = np.random.default_rng(1)
    cams = rng.normal(0, 0.05, (V, 6)).astype(np.float32)
    kp = rng.uniform(100, 400, (V, KMAX, 2)).astype(np.float32)
    K = np.array([[500, 0, 250], [0, 500, 250], [0, 0, 1]], np.float32)
    sj = dataclasses.replace(sj, cameras=jnp.asarray(cams), camera_valid=jnp.asarray([True, True, True, False]))
    st = interop.state_from_numpy(_np_state(sj))
    # Put a third of the observations near their projections so the 6 px
    # gate keeps some and drops others.
    pj = j_tr.prune_observations(sj, jnp.asarray(kp), jnp.asarray(K), 200.0)
    pt = t_tr.prune_observations(st, torch.tensor(kp), torch.tensor(K), 200.0)
    _assert_states_equal(pj, pt)
    assert 0 < int(pt.points_valid.sum()) < int(st.points_valid.sum())
    fn = rng.integers(0, KMAX, 64).astype(np.int32)
    fd = rng.integers(-1, KMAX, 64).astype(np.int32)
    mv = rng.uniform(size=64) > 0.3
    rj = j_tr.find_2d3d(pj, 3, 1, jnp.asarray(fn), jnp.asarray(fd), jnp.asarray(mv))
    rt = t_tr.find_2d3d(pt, 3, 1, torch.tensor(fn), torch.tensor(fd), torch.tensor(mv))
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # The compact BA observation table: the reference pads it to a bucket,
    # the port holds exactly the real rows, in the same order.
    n = int(pt.n_points)
    pp = np.array([250.0, 250.0], np.float32)
    cj, ptj, xyj, wj, _ = j_tr.observation_table_compact(pj, jnp.asarray(kp), jnp.asarray(pp), 4096, n)
    ct, ptt, xyt, wt = t_tr.observation_table_compact(pt, torch.tensor(kp), torch.tensor(pp), n)
    real = np.asarray(wj) > 0
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj)[real])
    np.testing.assert_array_equal(ptt.numpy(), np.asarray(ptj)[real])
    np.testing.assert_allclose(xyt.numpy(), np.asarray(xyj)[real])


def test_dense_observation_table_matches(grown_states):
    """The dense (P*V) table: every track slot a row in (point, view) order,
    equal to the reference's; its weighted rows are the compact table."""
    sj, _ = grown_states
    sj = dataclasses.replace(sj, camera_valid=jnp.asarray([True, True, False, True]))
    st = interop.state_from_numpy(_np_state(sj))
    rng = np.random.default_rng(6)
    kp = rng.uniform(100, 400, (V, KMAX, 2)).astype(np.float32)
    pp = np.array([250.0, 250.0], np.float32)
    oj = j_tr.observation_table(sj, jnp.asarray(kp), jnp.asarray(pp))
    ot = t_tr.observation_table(st, torch.tensor(kp), torch.tensor(pp))
    assert ot[0].shape == (CAP * V,)
    for a, b in zip(oj, ot):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    w = ot[3] > 0
    assert 0 < int(w.sum()) < CAP * V
    ct, ptt, xyt, wt = t_tr.observation_table_compact(st, torch.tensor(kp), torch.tensor(pp))
    np.testing.assert_array_equal(ct.numpy(), ot[0][w].numpy())
    np.testing.assert_array_equal(ptt.numpy(), ot[1][w].numpy())
    np.testing.assert_array_equal(xyt.numpy(), ot[2][w].numpy())
    np.testing.assert_array_equal(wt.numpy(), ot[3][w].numpy())


def test_make_problem_matches_reference(synthetic_scene):
    """make_problem from the same numpy arrays: equal fields and dtypes, and
    the same BA run from it."""
    from sfm_danpipeline_torch.ba.problem import make_problem as t_make_problem

    prob_j = _problem_from_scene(synthetic_scene, cam_noise=0.01, pt_noise=0.02, obs_noise=0.5, seed=5)
    args = {k: np.asarray(getattr(prob_j, k)) for k in (
        "cameras", "focal", "points", "obs_cam", "obs_pt", "obs_xy", "obs_w", "fix_cam",
    )}
    prob_t = t_make_problem(**{k: v.astype(np.float64) if v.dtype.kind == "f" else v for k, v in args.items()})
    want = {"cameras": torch.float32, "obs_cam": torch.int32, "obs_w": torch.float32,
            "fix_cam": torch.bool, "fix_focal": torch.bool}
    for k, dtype in want.items():
        assert getattr(prob_t, k).dtype == dtype, k
    for k in args:
        np.testing.assert_array_equal(getattr(prob_t, k).numpy(), np.asarray(getattr(prob_j, k)), err_msg=k)
    assert not bool(prob_t.fix_focal) and prob_t.fix_pt is None
    assert not bool(t_make_problem(**{**args, "fix_cam": None}).fix_cam.any())
    rj = j_run_ba(prob_j, JBAConfig(max_iterations=10))
    rt = t_run_ba(prob_t, BAConfig(max_iterations=10))
    assert abs(float(rt.final_cost) - float(rj.final_cost)) <= 1e-4 * float(rj.final_cost)


def test_retriangulate_points_match(synthetic_scene):
    sc = synthetic_scene
    n = 60
    sj = j_tr.init_state(3, n, 128, float(sc["K"][0, 0]))
    kp = np.stack([sc["obs"][v, :n] for v in (0, 2, 4)]).astype(np.float32)
    cams = []
    from sfm_danpipeline_tpu.ops.lie import log_so3

    for v in (0, 2, 4):
        cams.append(np.concatenate([np.asarray(log_so3(jnp.asarray(sc["R"][v]))), sc["t"][v]]))
    feats = np.arange(n, dtype=np.int32)
    sj = dataclasses.replace(sj, cameras=jnp.asarray(np.stack(cams), jnp.float32), camera_valid=jnp.ones(3, bool))
    noisy = (sc["points"][:n] + 0.05).astype(np.float32)
    sj = j_tr.add_points(sj, jnp.asarray(noisy), jnp.zeros((n, 3)), 0, jnp.asarray(feats), 1, jnp.asarray(feats), jnp.ones(n, bool))
    sj = j_tr.add_points(sj, jnp.asarray(noisy), jnp.zeros((n, 3)), 0, jnp.asarray(feats), 2, jnp.asarray(feats), jnp.ones(n, bool))
    st = interop.state_from_numpy(_np_state(sj))
    K = sc["K"].astype(np.float32)
    rj = j_tr.retriangulate_points(sj, jnp.asarray(kp), jnp.asarray(K))
    rt = t_tr.retriangulate_points(st, torch.tensor(kp), torch.tensor(K))
    np.testing.assert_allclose(rt.points_xyz.numpy()[:n], np.asarray(rj.points_xyz)[:n], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rt.points_xyz.numpy()[:n], sc["points"][:n], atol=1e-2)


def _port_problem(prob_j, **extra):
    fields = {f.name: np.asarray(getattr(prob_j, f.name)) for f in dataclasses.fields(prob_j) if getattr(prob_j, f.name) is not None}
    fields.update(extra)
    return interop.problem_from_numpy(fields)


@pytest.mark.parametrize(
    "noise", [dict(cam_noise=0.01, pt_noise=0.03, obs_noise=0.5, seed=13),
              dict(cam_noise=0.02, pt_noise=0.02, seed=11)],
)
def test_ba_final_cost_matches_reference_and_oracle(synthetic_scene, noise):
    prob_j = _problem_from_scene(synthetic_scene, **noise)
    rj = j_run_ba(prob_j, JBAConfig(max_iterations=60))
    rt = t_run_ba(_port_problem(prob_j), BAConfig(max_iterations=60))
    c0j, c0t = float(rj.initial_cost), float(rt.initial_cost)
    assert abs(c0t - c0j) <= 1e-5 * c0j
    cj, ct = float(rj.final_cost), float(rt.final_cost)
    floor = 1e-3  # noise-free problems converge to ~0 cost on both sides
    assert abs(ct - cj) <= 1e-4 * max(cj, floor), (cj, ct)
    ref = solve_reference_problem(prob_j)
    if ref.final_cost > floor:
        assert abs(ct - ref.final_cost) / ref.final_cost < 0.01, (ct, ref.final_cost)
    else:
        assert ct < 10 * floor


def test_frozen_cameras_match_reference(synthetic_scene):
    prob_j = _problem_from_scene(synthetic_scene, cam_noise=0.01, pt_noise=0.02, seed=3)
    fix_cam = np.asarray(prob_j.fix_cam).copy()
    fix_cam[1] = True
    prob_j = dataclasses.replace(prob_j, fix_cam=jnp.asarray(fix_cam))
    rj = j_run_ba(prob_j, JBAConfig(max_iterations=8))
    rt = t_run_ba(_port_problem(prob_j), BAConfig(max_iterations=8))
    np.testing.assert_array_equal(rt.cameras.numpy()[:2], np.asarray(prob_j.cameras)[:2])
    assert abs(float(rt.final_cost) - float(rj.final_cost)) <= 1e-4 * float(rj.final_cost)


def test_frozen_points_match_oracle(synthetic_scene):
    """Local-window BA freezes points through `fix_pt`. The reference's LM
    loop drops `fix_pt` when it rebuilds the problem (ba/solver.py, run_ba
    body), so frozen points move there; the port follows the documented
    semantics, which the float64 oracle also implements."""
    prob_j = _problem_from_scene(synthetic_scene, cam_noise=0.01, pt_noise=0.02, obs_noise=0.5, seed=3)
    P = prob_j.points.shape[0]
    fix_pt = np.zeros(P, bool)
    fix_pt[: P // 2] = True
    rt = t_run_ba(_port_problem(prob_j, fix_pt=fix_pt), BAConfig(max_iterations=60))
    np.testing.assert_array_equal(rt.points.numpy()[: P // 2], np.asarray(prob_j.points)[: P // 2])
    assert not np.allclose(rt.points.numpy()[P // 2 :], np.asarray(prob_j.points)[P // 2 :])
    ref = solve_reference_problem(dataclasses.replace(prob_j, fix_pt=jnp.asarray(fix_pt)))
    assert abs(float(rt.final_cost) - ref.final_cost) / ref.final_cost < 0.01


@pytest.mark.parametrize("shape", [(), (3,), (6, 3)])
def test_segment_sum_is_the_scatter_sum(shape):
    """ops/reduce's order-fixed sum by segment (the normal blocks use it)
    against float64 `index_add_`: rtol 1e-6 (float32 sums in another order);
    empty segments give zeros, one plan serves several tensors, and the same
    call twice gives the same bits."""
    from sfm_danpipeline_torch.ops.reduce import planned_sum, segment_plan

    rng = np.random.default_rng(len(shape))
    seg = torch.tensor(rng.integers(0, 17, 500))
    seg[seg == 5] = 6  # segment 5 is empty
    x = torch.tensor(rng.normal(size=(500,) + shape).astype(np.float32))
    want = torch.zeros((20,) + shape, dtype=torch.float64).index_add_(0, seg, x.double())
    plan = segment_plan(seg, 20)
    got = planned_sum(x, plan)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert float(got[5].abs().sum()) == 0.0 and float(got[17:].abs().sum()) == 0.0
    assert torch.equal(planned_sum(x, segment_plan(seg, 20)), got)
    assert torch.equal(planned_sum(2 * x, plan), 2 * got)
    assert planned_sum(x[:0], segment_plan(seg[:0], 4)).shape == (4,) + shape
