"""End-to-end parity of the port's sparse main path with the JAX reference:
both `SfMPipeline.run`s on the rendered V=6 courtyard (240x320,
ring_fraction 0.12, max_keypoints 1024, otherwise the default config).

Two stage tests then feed the reference's own intermediate state to the
port through `interop`: its keypoints to the port's matcher (valid match
sets equal), and its final reconstruction to the port's BA step (the same
cost: the state is already converged, so the port's BA must start and end
within 1e-4 relative of the reference's final cost).

The runs cannot agree bitwise (RANSAC draws differ: JAX threefry vs a
torch.Generator), so they are held at the level of the repo's own
quality gates: equal registration counts, BA RMS under 0.5 px on both
sides and within 0.1 px of each other, ATE under 1% of the trajectory
diameter on both sides, and point counts within 15%. The port runs its
CPU path (knn2_torch for the kernel). Under tests/conftest.py the JAX
package sees 8 CPU devices, so its run takes the pair-sharded matching
path (parallel/matching.py), which has the same semantics; the port has
one device and no sharded path.
"""
import numpy as np
import pytest
import torch

from sfm_danpipeline_tpu.config import FeatureConfig as JFeatureConfig
from sfm_danpipeline_tpu.config import PipelineConfig as JPipelineConfig
from sfm_danpipeline_tpu.pipeline.sfm import SfMPipeline as JPipeline
from sfm_danpipeline_tpu.utils.metrics import camera_centers as j_centers
from sfm_danpipeline_tpu.ops.matching import match_all_pairs as j_match_all_pairs
from sfm_danpipeline_torch import interop
from sfm_danpipeline_torch.config import FeatureConfig, PipelineConfig
from sfm_danpipeline_torch.ops.matching import match_all_pairs
from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline, ba_step
from sfm_danpipeline_torch.utils.metrics import aligned_rmse, camera_centers
from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene


def _ate_frac(centers, scene, regs):
    g = scene.centers[regs]
    return aligned_rmse(centers[regs], g) / float(np.linalg.norm(g.max(0) - g.min(0)))


@pytest.fixture(scope="module")
def runs():
    scene = make_courtyard_scene(
        n_views=6, height=240, width=320, ring_fraction=0.12, seed=0
    )
    rj = JPipeline(JPipelineConfig(features=JFeatureConfig(max_keypoints=1024))).run(
        scene.images, scene.intrinsics
    )
    # One intra-op thread: the port's small eager ops gain nothing from
    # more, and the suite runs several test workers side by side.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rt = SfMPipeline(PipelineConfig(features=FeatureConfig(max_keypoints=1024))).run(
            scene.images, scene.intrinsics
        )
    finally:
        torch.set_num_threads(threads)
    out = {"scene": scene, "jax_result": rj}
    for name, res, centers in (
        ("jax", rj, j_centers(np.asarray(rj.state.cameras))),
        ("torch", rt, camera_centers(rt.state.cameras.numpy())),
    ):
        regs = sorted(res.registered_views)
        out[name] = dict(res.metrics, ate_frac=_ate_frac(centers, scene, regs), regs=regs)
    return out


def test_same_views_registered(runs):
    assert runs["torch"]["n_registered"] == runs["jax"]["n_registered"] == 6
    assert runs["torch"]["regs"] == runs["jax"]["regs"]
    assert runs["torch"]["n_unmerged_views"] == 0


def test_ba_rms_agrees(runs):
    j, t = runs["jax"]["ba_rms_px"], runs["torch"]["ba_rms_px"]
    assert j < 0.5 and t < 0.5, (j, t)
    assert abs(j - t) < 0.1, (j, t)


def test_trajectory_error_under_one_percent(runs):
    assert runs["jax"]["ate_frac"] < 0.01, runs["jax"]["ate_frac"]
    assert runs["torch"]["ate_frac"] < 0.01, runs["torch"]["ate_frac"]


def test_point_counts_agree(runs):
    j, t = runs["jax"]["n_points"], runs["torch"]["n_points"]
    assert abs(j - t) <= 0.15 * j, (j, t)


def test_stage_matching_on_reference_keypoints(runs):
    import jax.numpy as jnp

    kp_j = runs["jax_result"].keypoints
    kp = interop.keypoints_from_numpy({k: np.asarray(getattr(kp_j, k)) for k in ("xy", "sigma", "angle", "response", "descriptors", "valid")})
    pi, pj = np.triu_indices(6, 1)
    kw = dict(ratio=0.9, max_matches=1024, strict_ratio=0.8, dup_radius=0.5, dedup=False)
    mj = j_match_all_pairs(
        kp_j.descriptors, kp_j.valid, jnp.asarray(pi, jnp.int32), jnp.asarray(pj, jnp.int32), xy=kp_j.xy, **kw
    )
    mt = match_all_pairs(
        kp.descriptors, kp.valid, torch.tensor(pi, dtype=torch.int32), torch.tensor(pj, dtype=torch.int32), xy=kp.xy, **kw
    )
    for p in range(len(pi)):
        sj = {(int(a), int(b)) for a, b, v in zip(mj.idx_a[p], mj.idx_b[p], mj.valid[p]) if v}
        st = {(int(a), int(b)) for a, b, v in zip(mt.idx_a[p], mt.idx_b[p], mt.valid[p]) if v}
        assert st == sj, p


def test_stage_ba_on_reference_state(runs):
    rj = runs["jax_result"]
    st = interop.state_from_numpy({k: np.asarray(getattr(rj.state, k)) for k in (
        "points_xyz", "points_rgb", "points_valid", "track_feat", "feat_to_point",
        "cameras", "camera_valid", "focal", "n_points")})
    intr = runs["scene"].intrinsics
    pp = torch.tensor([intr.cx, intr.cy], dtype=torch.float32)
    fix = torch.zeros(6, dtype=torch.bool)
    fix[runs["jax"]["baseline_pair_i"]] = True
    cfg = PipelineConfig(features=FeatureConfig(max_keypoints=1024))
    _, c0, c1, _, n_obs = ba_step(
        st, torch.tensor(np.asarray(rj.keypoints.xy)), pp, fix, cfg, cfg.ba.max_iterations
    )
    ref = runs["jax"]["ba_final_cost"]
    assert int(n_obs) == int(runs["jax"]["ba_n_obs"])
    assert abs(float(c0) - ref) <= 1e-4 * ref, (float(c0), ref)
    assert abs(float(c1) - ref) <= 1e-4 * ref, (float(c1), ref)
