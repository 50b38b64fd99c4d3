"""Parity of the port's in-process sharded paths (sfm_danpipeline_torch.ba.
sharded, parallel/matching.py, the sharded routing of SfMPipeline) with the
single-device port and with the JAX reference on its simulated 8-device CPU
mesh (tests/conftest.py).

The sharded BA is held to tests/test_sharded_ba.py's tolerances (equal
iterations, final cost to rtol 1e-3, cameras to 5e-4, points to 5e-3): the
shards' normal blocks are summed in another order than one device's, so
the trajectories agree to float32 reduction-order noise. Sharded matching
computes every pair exactly as the unsharded call does, so its index sets
are held equal. The shard devices are a list that repeats the CPU, as the
card's smoke run repeats cuda:0.

The pipeline with two shard devices runs everything before its final BA on
identical inputs, so those numbers are held equal. Its final 50-iteration
BA (one camera fixed) ends in a flat float32 valley where the summation
order moves the endpoint along directions the cost does not see: on this
scene the weakly held y translation of the last camera ends 2.2e-3 apart at
the same cost (11.62791). So the test holds what the summation order cannot
move: the final cost to rtol 1e-3, the rotations to 2e-3 (measured 1.2e-4),
and the camera centres after a similarity alignment (the gauge) to an RMS
of 2e-3 (measured 3.2e-4, against a trajectory error of 4.0e-2 from the
scene's true centres).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_danpipeline_tpu.ba.sharded import default_mesh
from sfm_danpipeline_tpu.ba.sharded import run_ba_sharded as j_run_ba_sharded
from sfm_danpipeline_tpu.config import BAConfig as JBAConfig
from sfm_danpipeline_tpu.parallel.matching import match_all_pairs_sharded as j_match_sharded
from sfm_danpipeline_torch import interop
from sfm_danpipeline_torch.ba import sharded as t_sharded
from sfm_danpipeline_torch.ba.solver import run_ba
from sfm_danpipeline_torch.config import BAConfig
from sfm_danpipeline_torch.ops.matching import match_all_pairs
from sfm_danpipeline_torch.parallel.matching import match_all_pairs_sharded
from sfm_danpipeline_torch.utils import knn_cases
from sfm_danpipeline_torch.utils.metrics import aligned_rmse, camera_centers
from tests.test_ba import _problem_from_scene, _rms_px
from torch_testing import one_torch_thread  # noqa: F401

CPU8 = [torch.device("cpu")] * 8
PROBLEM_FIELDS = (
    "cameras", "focal", "points", "obs_cam", "obs_pt", "obs_xy", "obs_w", "fix_cam", "fix_focal",
)


def _torch_problem(prob):
    return interop.problem_from_numpy({k: np.asarray(getattr(prob, k)) for k in PROBLEM_FIELDS})


def test_sharded_matches_single_device_and_reference(synthetic_scene):
    prob = _problem_from_scene(synthetic_scene, pt_noise=0.04, seed=11)
    tp = _torch_problem(prob)
    cfg = BAConfig(max_iterations=20)
    res1 = run_ba(tp, cfg)
    res8 = t_sharded.run_ba_sharded(tp, cfg, CPU8)
    resj = j_run_ba_sharded(prob, JBAConfig(max_iterations=20), mesh=default_mesh())
    for other in (res1, resj):
        assert res8.iterations == int(other.iterations)
        np.testing.assert_allclose(float(res8.final_cost), float(other.final_cost), rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(res8.cameras.numpy(), np.asarray(other.cameras), atol=5e-4)
        np.testing.assert_allclose(res8.points.numpy(), np.asarray(other.points), atol=5e-3)


def test_sharded_converges_from_noise(synthetic_scene):
    prob = _problem_from_scene(synthetic_scene, cam_noise=0.02, pt_noise=0.05, seed=13)
    res = t_sharded.run_ba_sharded(_torch_problem(prob), BAConfig(max_iterations=40), CPU8)
    assert _rms_px(res, prob.n_obs) < 0.05


def test_sharded_reruns_are_equal_bit_for_bit(synthetic_scene):
    tp = _torch_problem(_problem_from_scene(synthetic_scene, pt_noise=0.04, seed=11))
    a = t_sharded.run_ba_sharded(tp, BAConfig(max_iterations=10), CPU8)
    b = t_sharded.run_ba_sharded(tp, BAConfig(max_iterations=10), CPU8)
    assert torch.equal(a.cameras, b.cameras) and torch.equal(a.points, b.points)


def test_padding_to_odd_multiple(synthetic_scene):
    tp = _torch_problem(_problem_from_scene(synthetic_scene, pt_noise=0.02))
    assert tp.n_obs % 7 != 0
    padded = t_sharded.pad_observations(tp, 7)
    assert padded.n_obs % 7 == 0 and padded.n_obs - tp.n_obs < 7
    assert float(torch.sum(padded.obs_w)) == float(torch.sum(tp.obs_w))
    assert torch.all(padded.obs_w[tp.n_obs:] == 0)
    assert t_sharded.pad_observations(padded, 7) is padded


def test_sharded_respects_fixed_camera(synthetic_scene):
    tp = _torch_problem(_problem_from_scene(synthetic_scene, cam_noise=0.02, seed=17))
    res = t_sharded.run_ba_sharded(tp, BAConfig(max_iterations=10), CPU8)
    assert torch.equal(res.cameras[0], tp.cameras[0])


def test_default_devices_are_the_cards():
    if torch.cuda.is_available():
        assert t_sharded.default_devices()[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            t_sharded.default_devices()


@pytest.mark.parametrize("n_shards", [4, 8])
def test_sharded_matching_equals_unsharded_and_reference(n_shards):
    """7 views -> 21 pairs, a multiple of neither shard count."""
    case = knn_cases.matches_case(7, 256, 32, 0.25)
    desc, valid, xy = (torch.as_tensor(a) for a in (case.desc, case.valid, case.xy))
    pi, pj = np.triu_indices(7, 1)
    kw = dict(ratio=0.9, max_matches=128, strict_ratio=0.8, dup_radius=0.5)
    plain = match_all_pairs(desc, valid, torch.as_tensor(pi), torch.as_tensor(pj), xy=xy, **kw)
    got = match_all_pairs_sharded(
        desc, valid, torch.as_tensor(pi), torch.as_tensor(pj), xy=xy,
        devices=[torch.device("cpu")] * n_shards, **kw,
    )
    ref = j_match_sharded(
        jnp.asarray(case.desc), jnp.asarray(case.valid), jnp.asarray(pi), jnp.asarray(pj),
        xy=jnp.asarray(case.xy), **kw,
    )
    for f in ("idx_a", "idx_b", "valid"):
        assert torch.equal(getattr(got, f), getattr(plain, f)), f
        v = np.asarray(ref.valid)
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_array_equal(np.where(v, a, -1), np.where(v, b, -1), err_msg=f)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert torch.equal(got.dist, plain.dist) and torch.equal(got.lowe, plain.lowe)


def test_sharded_matching_without_xy():
    """xy None: co-location exclusion off (dup_radius 0), as the reference."""
    case = knn_cases.matches_case(4, 128, 32, 0.25)
    desc, valid = torch.as_tensor(case.desc), torch.as_tensor(case.valid)
    pi, pj = (torch.as_tensor(a) for a in np.triu_indices(4, 1))
    plain = match_all_pairs(desc, valid, pi, pj, max_matches=64)
    got = match_all_pairs_sharded(desc, valid, pi, pj, max_matches=64, devices=["cpu"] * 4)
    assert torch.equal(got.idx_b, plain.idx_b) and torch.equal(got.valid, plain.valid)


@pytest.fixture(scope="module")
def pipeline_runs():
    """The port's SfMPipeline on the V=6 test scene twice: on one device,
    and with two shard devices and ba.sharded_min_obs = 16, with the two
    sharded entry points spied on."""
    from sfm_danpipeline_torch.config import FeatureConfig, PipelineConfig
    from sfm_danpipeline_torch.pipeline import sfm as t_sfm
    from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene
    from torch_v6_reference import V6_MAX_KEYPOINTS, V6_SCENE

    scene = make_courtyard_scene(**V6_SCENE)
    cfg = PipelineConfig(features=FeatureConfig(max_keypoints=V6_MAX_KEYPOINTS))
    cfg = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, sharded_min_obs=16))
    plain = t_sfm.SfMPipeline(cfg, device="cpu").run(scene.images, scene.intrinsics)
    calls = {"match": [], "ba": []}
    orig_match, orig_ba = t_sfm.match_all_pairs_sharded, t_sfm.run_ba_sharded

    def spy_match(*a, **kw):
        calls["match"].append(kw["devices"])
        return orig_match(*a, **kw)

    def spy_ba(prob, cfg_ba, devices, **kw):
        calls["ba"].append((list(devices), kw.get("max_iterations")))
        return orig_ba(prob, cfg_ba, devices, **kw)

    t_sfm.match_all_pairs_sharded, t_sfm.run_ba_sharded = spy_match, spy_ba
    try:
        sharded = t_sfm.SfMPipeline(cfg, device="cpu", shard_devices=["cpu", "cpu"]).run(
            scene.images, scene.intrinsics
        )
    finally:
        t_sfm.match_all_pairs_sharded, t_sfm.run_ba_sharded = orig_match, orig_ba
    return cfg, plain, sharded, calls


def test_pipeline_takes_both_sharded_branches(pipeline_runs):
    cfg, _, _, calls = pipeline_runs
    cpu2 = [torch.device("cpu")] * 2
    assert calls["match"] == [cpu2]
    # The final solve only: seed, per-view and merge solves are intermediate.
    assert calls["ba"] == [(cpu2, cfg.ba.max_iterations)]


def test_pipeline_sharded_equals_single_device(pipeline_runs):
    _, plain, sharded, _ = pipeline_runs
    assert sharded.registered_views == plain.registered_views == list(range(6))
    # Everything before the final BA ran on identical matches.
    for k in ("n_baseline_points", "baseline_pair_i", "baseline_pair_j", "ba_initial_cost"):
        assert sharded.metrics[k] == plain.metrics[k], k
    np.testing.assert_allclose(
        sharded.metrics["ba_final_cost"], plain.metrics["ba_final_cost"], rtol=1e-3
    )
    cams_s, cams_p = sharded.state.cameras.numpy(), plain.state.cameras.numpy()
    np.testing.assert_allclose(cams_s[:, :3], cams_p[:, :3], atol=2e-3)
    assert aligned_rmse(camera_centers(cams_s), camera_centers(cams_p)) <= 2e-3
    assert abs(sharded.metrics["n_points"] - plain.metrics["n_points"]) <= 2
    assert sharded.metrics["ba_rms_px"] < 1.0


def test_pipeline_default_shard_devices_on_cpu():
    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline

    assert SfMPipeline(device="cpu").shard_devices == [torch.device("cpu")]
