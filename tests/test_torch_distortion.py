"""Lens distortion in the port, against the JAX reference: twins of
tests/test_distortion.py's pose/triangulation case and BA case, and both
packages' SfMPipeline on the V=6 courtyard with its keypoints pushed
through a known distortion and passed as `precomputed_keypoints`, which
takes the pipeline's canonicalization branch (keypoints undistorted once
into ideal pixels, `raw_xy` kept; pipeline/sfm.py).

Tolerances: the two-view pose as in tests/test_torch_ransac.py (the
reference's draws injected; rotation within 2e-3 rad, baseline within
2e-3, inlier masks agreeing on >= 99%) plus the reference test's own gates
against the truth; triangulation and undistortion within 1e-4; BA final
costs within 1e-4 relative plus the reference test's gates. The pipeline
runs are held at the level of their quality gates, as tests/test_torch_slice.py
holds the undistorted ones: equal registered views, RMS under 0.5 px on
both sides and within 0.1 px of each other, ATE under 1% of the diameter
on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sfm_danpipeline_tpu.ops import epipolar as j_epi
from sfm_danpipeline_tpu.ops import projection as j_proj
from sfm_danpipeline_tpu.ops.lie import exp_so3 as j_exp_so3
from sfm_danpipeline_tpu.ops.ransac import sample_indices as j_sample
from sfm_danpipeline_torch.ba.problem import make_problem
from sfm_danpipeline_torch.ba.solver import run_ba
from sfm_danpipeline_torch.config import BAConfig, FeatureConfig, PipelineConfig
from sfm_danpipeline_torch.ops import projection as t_proj
from sfm_danpipeline_torch.ops.epipolar import estimate_relative_pose
from sfm_danpipeline_torch.ops.lie import log_so3
from sfm_danpipeline_torch.ops.sift import Keypoints
from sfm_danpipeline_torch.ops.triangulation import pose_matrix, triangulate_dlt
from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline
from sfm_danpipeline_torch.utils.metrics import aligned_rmse, camera_centers
from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene
from torch_testing import one_torch_thread  # noqa: F401
from torch_v6_reference import V6_MAX_KEYPOINTS, V6_SCENE, reference_v6

DIST = np.array([-0.2, 0.05, 0.001, -0.001, 0.01], np.float32)


def _scene(seed=3, n=200):
    """tests/test_distortion.py's two-camera scene, as numpy."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    X[:, 2] += 4.0
    K = np.array([[800.0, 0, 320.0], [0, 800.0, 240.0], [0, 0, 1.0]], np.float32)
    R2 = np.asarray(j_exp_so3(jnp.asarray([0.02, -0.3, 0.01])))
    t2 = np.asarray([-0.8, 0.05, 0.1], np.float32)
    return X, K, R2, t2


def _rot_deg(Ra, Rb):
    return float(np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1))))


def _observe(X, R, t, K):
    """Distorted detections and their undistorted normalized coords."""
    T = torch.tensor
    raw = t_proj.project(T(X), T(R), T(t), T(K), dist=T(DIST))
    return raw, t_proj.undistort_points(raw, T(K), T(DIST), iters=8)


def test_pose_and_triangulation_under_distortion():
    X, K, R2, t2 = _scene()
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    raw1, x1 = _observe(X, eye, zero, K)
    raw2, x2 = _observe(X, R2, t2, K)
    for raw, x in ((raw1, x1), (raw2, x2)):
        xj = j_proj.undistort_points(jnp.asarray(raw.numpy()), jnp.asarray(K), jnp.asarray(DIST), iters=8)
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-4)
    valid = np.ones(len(X), bool)
    key = jax.random.key(0)
    pj = j_epi.estimate_relative_pose(
        key, jnp.asarray(x1.numpy()), jnp.asarray(x2.numpy()), jnp.asarray(valid), focal=float(K[0, 0])
    )
    samples = torch.tensor(np.asarray(j_sample(key, jnp.asarray(valid), 512, 8)))
    res = estimate_relative_pose(None, x1, x2, torch.tensor(valid), focal=float(K[0, 0]), samples=samples)
    assert bool(res.ok) and bool(pj.ok)
    assert np.radians(_rot_deg(res.R.numpy(), np.asarray(pj.R))) < 2e-3
    np.testing.assert_allclose(res.t.numpy(), np.asarray(pj.t), atol=2e-3)
    assert np.mean(res.inliers.numpy() == np.asarray(pj.inliers)) >= 0.99
    # The reference test's gates: rotation within a degree, baseline
    # direction within ~1 degree.
    assert _rot_deg(res.R.numpy(), R2) < 1.0
    tdir = res.t.numpy() / np.linalg.norm(res.t.numpy())
    tgt = t2 / np.linalg.norm(t2)
    assert min(np.linalg.norm(tdir - tgt), np.linalg.norm(tdir + tgt)) < 0.03
    # Triangulation with the true pose reproduces the scene.
    Xt = triangulate_dlt(
        pose_matrix(torch.eye(3), torch.zeros(3)), pose_matrix(torch.tensor(R2), torch.tensor(t2)), x1, x2
    )
    np.testing.assert_allclose(Xt.numpy(), X, atol=5e-3)


def test_ba_converges_on_distorted_calibration():
    """BA on ideal-pixel observations derived from distorted detections
    reaches the noise floor, and ends where the reference's BA does."""
    from sfm_danpipeline_tpu.ba.problem import make_problem as j_make_problem
    from sfm_danpipeline_tpu.ba.solver import run_ba as j_run_ba
    from sfm_danpipeline_tpu.config import BAConfig as JBAConfig

    X, K, R2, t2 = _scene(n=120)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    pp = K[:2, 2]
    rng = np.random.default_rng(7)
    cams = np.stack([np.zeros(6, np.float32), np.r_[log_so3(torch.tensor(R2)).numpy(), t2]])
    obs_cam, obs_pt, obs_xy = [], [], []
    for ci, (R, t) in enumerate(((eye, zero), (R2, t2))):
        _, xn = _observe(X, R, t, K)
        ideal = xn.numpy() * K[0, 0] + pp
        obs_cam.append(np.full(len(X), ci, np.int32))
        obs_pt.append(np.arange(len(X), dtype=np.int32))
        obs_xy.append(ideal - pp)
    args = dict(
        cameras=cams, focal=float(K[0, 0]),
        points=X + rng.normal(0, 0.02, X.shape).astype(np.float32),
        obs_cam=np.concatenate(obs_cam), obs_pt=np.concatenate(obs_pt),
        obs_xy=np.concatenate(obs_xy).astype(np.float32), obs_w=np.ones(2 * len(X), np.float32),
        fix_cam=np.array([True, True]), fix_focal=True,
    )
    res = run_ba(make_problem(**args), BAConfig(max_iterations=30))
    rj = j_run_ba(j_make_problem(**{k: jnp.asarray(v) for k, v in args.items()}), JBAConfig(max_iterations=30))
    rms = float(np.sqrt(2.0 * float(res.final_cost) / len(args["obs_xy"])))
    assert rms < 0.05  # px: the undistortion fixed point's noise floor
    np.testing.assert_allclose(res.points.numpy(), X, atol=1e-2)
    assert abs(float(res.final_cost) - float(rj.final_cost)) <= 1e-4 * max(float(rj.final_cost), 1e-3)


def _ate_frac(centers, scene, regs):
    g = scene.centers[regs]
    return aligned_rmse(centers[regs], g) / float(np.linalg.norm(g.max(0) - g.min(0)))


def test_pipelines_on_distorted_keypoints():
    """Both SfMPipelines on the reference's own V=6 SIFT keypoints moved
    through DIST (what a lens with that calibration would have detected),
    with the scene's intrinsics carrying DIST."""
    from sfm_danpipeline_tpu.config import FeatureConfig as JFeatureConfig
    from sfm_danpipeline_tpu.config import PipelineConfig as JPipelineConfig
    from sfm_danpipeline_tpu.ops.sift import Keypoints as JKeypoints
    from sfm_danpipeline_tpu.pipeline.sfm import SfMPipeline as JPipeline
    from sfm_danpipeline_tpu.utils.metrics import camera_centers as j_centers

    ref = reference_v6()
    kp = {f.name: np.asarray(getattr(ref.result.keypoints, f.name)) for f in dataclasses.fields(JKeypoints)}
    K = np.asarray(ref.scene.intrinsics.K, np.float32)
    xn = (kp["xy"] - K[:2, 2]) / K[0, 0]
    xd = np.asarray(j_proj.distort_normalized(jnp.asarray(xn), jnp.asarray(DIST)))
    kp["xy"] = (xd * K[0, 0] + K[:2, 2]).astype(np.float32)
    moved = np.linalg.norm(kp["xy"] - np.asarray(ref.result.keypoints.xy), axis=-1)[kp["valid"]]
    assert moved.max() > 1.0  # the lens moves the detections by whole pixels

    jscene = ref.scene
    rj = JPipeline(JPipelineConfig(features=JFeatureConfig(max_keypoints=V6_MAX_KEYPOINTS))).run(
        jscene.images, dataclasses.replace(jscene.intrinsics, dist=DIST),
        precomputed_keypoints=JKeypoints(**{k: jnp.asarray(v) for k, v in kp.items()}),
    )
    scene = make_courtyard_scene(**V6_SCENE)
    rt = SfMPipeline(PipelineConfig(features=FeatureConfig(max_keypoints=V6_MAX_KEYPOINTS)), device="cpu").run(
        scene.images, dataclasses.replace(scene.intrinsics, dist=DIST),
        precomputed_keypoints=Keypoints(**{k: torch.tensor(v) for k, v in kp.items()}),
    )
    # The canonicalization branch ran: raw detections kept beside the
    # ideal pixels the pipeline used.
    np.testing.assert_array_equal(np.asarray(rt.raw_xy), kp["xy"])
    np.testing.assert_array_equal(np.asarray(rj.raw_xy), kp["xy"])
    ideal = rt.keypoints.xy.numpy()[kp["valid"]]
    np.testing.assert_allclose(ideal, np.asarray(ref.result.keypoints.xy)[kp["valid"]], atol=0.05)

    regs_j, regs_t = sorted(rj.registered_views), sorted(rt.registered_views)
    assert regs_t == regs_j and len(regs_t) == 6
    mj, mt = rj.metrics, rt.metrics
    assert mj["ba_rms_px"] < 0.5 and mt["ba_rms_px"] < 0.5
    assert abs(mt["ba_rms_px"] - mj["ba_rms_px"]) < 0.1, (mt["ba_rms_px"], mj["ba_rms_px"])
    ate_j = _ate_frac(j_centers(np.asarray(rj.state.cameras)), jscene, regs_j)
    ate_t = _ate_frac(camera_centers(rt.state.cameras.numpy()), scene, regs_t)
    assert ate_j < 0.01 and ate_t < 0.01, (ate_j, ate_t)
