"""End-to-end parity of the port's sparse main path with the JAX reference:
both `SfMPipeline.run`s on the rendered V=6 courtyard (240x320,
ring_fraction 0.12, max_keypoints 1024, otherwise the default config).

Three stage tests then feed the reference's own intermediate state to the
port through `interop`: its keypoints to the port's matcher (valid match
sets equal), its final reconstruction to the port's BA step (the same
cost: the state is already converged, so the port's BA must start and end
within 1e-4 relative of the reference's final cost), and a perturbed copy
of it to one local-window BA step in both packages (equal final costs
within 1e-4 relative, and the points outside the local view's tracks move
alike: the reference freezes only the cameras outside the window).

The runs cannot agree bitwise (RANSAC draws differ: JAX threefry vs a
torch.Generator), so they are held at the level of the repo's own
quality gates: equal registration counts, BA RMS under 0.5 px on both
sides and within 0.1 px of each other, ATE under 1% of the trajectory
diameter on both sides, and point counts within 15%. The port runs its
CPU path (knn2_torch for the kernel). Under tests/conftest.py the JAX
package sees 8 CPU devices, so its run takes the pair-sharded matching
path (parallel/matching.py), which has the same semantics; the port has
one device and no sharded path.

A slow test holds the V=20 arc at 480x640, which splits into two
components that merge, to the same gates and bench.py's merge gates.
"""
import numpy as np
import pytest
import torch

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
from torch_v6_reference import V6_MAX_KEYPOINTS, V6_SCENE, reference_v6


def _ate_frac(centers, scene, regs):
    g = scene.centers[regs]
    return aligned_rmse(centers[regs], g) / float(np.linalg.norm(g.max(0) - g.min(0)))


@pytest.fixture(scope="module")
def runs():
    scene = make_courtyard_scene(**V6_SCENE)
    rj = reference_v6().result
    # One intra-op thread: the port's small eager ops gain nothing from
    # more, and the suite runs several test workers side by side.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rt = SfMPipeline(PipelineConfig(features=FeatureConfig(max_keypoints=V6_MAX_KEYPOINTS)), device="cpu").run(
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
    assert runs["torch"]["n_components"] == runs["jax"]["n_components"] == 1


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
    st = interop.state_from_numpy(reference_v6().state)
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


def test_stage_local_window_ba_matches_reference():
    from sfm_danpipeline_tpu.pipeline.sfm import _ba_step, _bucket
    from sfm_danpipeline_tpu.pipeline.tracks import ReconstructionState as JState

    from sfm_danpipeline_torch.config import BAConfig

    ref = reference_v6()
    rng = np.random.default_rng(0)
    st = dict(ref.state)
    st["points_xyz"] = (st["points_xyz"] + rng.normal(0, 0.02, st["points_xyz"].shape)).astype(np.float32)
    anchor = int(ref.result.metrics["baseline_pair_i"])
    cams = st["cameras"] + rng.normal(0, 2e-3, st["cameras"].shape)
    cams[anchor] = st["cameras"][anchor]
    st["cameras"] = cams.astype(np.float32)
    local_view, window = 4, 3
    cfg = ref.config
    intr = ref.scene.intrinsics
    pp = np.array([intr.cx, intr.cy], np.float32)
    fix = np.zeros(6, bool)
    fix[anchor] = True
    n_obs = int(((st["track_feat"] >= 0) & st["points_valid"][:, None]).sum())
    n_bucket = _bucket(int(st["n_points"]), cfg.max_points)
    n_obs_bucket = min(1 << (max(1024, n_obs) - 1).bit_length(), n_bucket * 6)
    iters = cfg.ba.intermediate_iterations
    js, jc0, jc1, _, _, _ = _ba_step(
        JState(**{k: np.asarray(v) for k, v in st.items()}), ref.keypoints_xy, pp, fix,
        n_bucket, n_obs_bucket, cfg.ba, True, float(cfg.geometry.max_reprojection_error_px),
        np.int32(iters), np.int32(local_view), window,
    )
    tcfg = PipelineConfig(
        features=FeatureConfig(max_keypoints=V6_MAX_KEYPOINTS), ba=BAConfig(local_window=window)
    )
    ts, tc0, tc1, _, _ = ba_step(
        interop.state_from_numpy(st), torch.tensor(ref.keypoints_xy), torch.tensor(pp),
        torch.tensor(fix), tcfg, iters, local_view=local_view,
    )
    assert abs(float(tc0) - float(jc0)) <= 1e-4 * float(jc0)
    assert abs(float(tc1) - float(jc1)) <= 1e-4 * float(jc1), (float(tc1), float(jc1))
    # Points the local view does not observe: the reference moves them too.
    off = (st["track_feat"][:, local_view] < 0) & st["points_valid"]
    move_j = np.linalg.norm(np.asarray(js.points_xyz)[off] - st["points_xyz"][off], axis=1)
    move_t = np.linalg.norm(ts.points_xyz.numpy()[off] - st["points_xyz"][off], axis=1)
    assert off.sum() > 20 and move_j.max() > 1e-3, (off.sum(), move_j.max())
    np.testing.assert_allclose(move_t, move_j, atol=1e-4)
    # The cameras outside the window stay where they were in both.
    np.testing.assert_array_equal(
        np.asarray(js.cameras) == st["cameras"], ts.cameras.numpy() == st["cameras"]
    )


@pytest.mark.slow
def test_v20_arc_splits_merges_and_meets_the_gates():
    """The V=20 arc at 480x640 with the default config through both
    packages: the reference registers 20/20 in two components merged by
    one Sim(3), and rotation averaging fires; the port must do the same
    and meet the merge and quality gates of bench.py."""
    scene = make_courtyard_scene(n_views=20, ring_fraction=0.4, seed=0)
    rj = JPipeline(JPipelineConfig()).run(scene.images, scene.intrinsics)
    rt = SfMPipeline(PipelineConfig(), device="cpu").run(scene.images, scene.intrinsics)
    for res, centers in (
        (rj, j_centers(np.asarray(rj.state.cameras))),
        (rt, camera_centers(rt.state.cameras.numpy())),
    ):
        m = res.metrics
        regs = sorted(res.registered_views)
        assert m["n_registered"] == 20, m
        assert m["n_components"] == 2 and m["n_merged_components"] == 1, m
        assert "rotavg_applied" in m, m
        assert m["n_cross_tracks"] >= 20 and m["merge_cross_med_px"] < 4, m
        assert m["ba_rms_px"] < 1.0, m
        assert _ate_frac(centers, scene, regs) < 0.01
