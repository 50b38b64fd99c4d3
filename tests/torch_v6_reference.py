"""The JAX reference's reconstruction of the V=6 rendered courtyard
(240x320, ring_fraction 0.12, max_keypoints 1024, otherwise the default
config), shared by the port's parity tests: the end-to-end slice test and
the merge, rotation-averaging and dense stage tests feed its state to both
packages. Computed once per test process.
"""
import functools
from types import SimpleNamespace

import numpy as np

V6_SCENE = dict(n_views=6, height=240, width=320, ring_fraction=0.12, seed=0)
V6_MAX_KEYPOINTS = 1024

STATE_FIELDS = (
    "points_xyz", "points_rgb", "points_valid", "track_feat", "feat_to_point",
    "cameras", "camera_valid", "focal", "n_points",
)


@functools.lru_cache(maxsize=None)
def reference_v6():
    """Scene, config, the reference's SfMResult, its state as numpy, the
    number of registration keys it took, and the reference's match tables
    for the same keypoints."""
    import jax.numpy as jnp

    from sfm_danpipeline_tpu.config import FeatureConfig, PipelineConfig
    from sfm_danpipeline_tpu.ops.matching import match_all_pairs
    from sfm_danpipeline_tpu.pipeline.incremental import build_match_tables
    from sfm_danpipeline_tpu.pipeline.sfm import SfMPipeline, _keypoint_colors, _pair_list
    from sfm_danpipeline_tpu.utils.synthscene import make_courtyard_scene

    scene = make_courtyard_scene(**V6_SCENE)
    cfg = PipelineConfig(features=FeatureConfig(max_keypoints=V6_MAX_KEYPOINTS))
    pipe = SfMPipeline(cfg)
    res = pipe.run(scene.images, scene.intrinsics)
    kp = res.keypoints
    V = scene.images.n_images
    pi, pj = _pair_list(V)
    loose = max(cfg.matching.ratio, cfg.matching.registration_ratio)
    matches = match_all_pairs(
        kp.descriptors, kp.valid, jnp.asarray(pi), jnp.asarray(pj), ratio=loose,
        max_matches=cfg.matching.max_matches, strict_ratio=cfg.matching.ratio,
        xy=kp.xy, dup_radius=cfg.matching.dup_radius, dedup=cfg.matching.dedup_matches,
    )
    strict = matches.at_ratio(cfg.matching.ratio)
    ft_a, ft_b, _ = build_match_tables(matches, jnp.asarray(pi), jnp.asarray(pj), V)
    _, _, vt_strict = build_match_tables(strict, jnp.asarray(pi), jnp.asarray(pj), V)
    return SimpleNamespace(
        scene=scene, config=cfg, result=res, key_n=pipe._key_n, pi=pi, pj=pj, strict=strict,
        state={k: np.asarray(getattr(res.state, k)) for k in STATE_FIELDS},
        keypoints_xy=np.asarray(kp.xy),
        colors=np.asarray(_keypoint_colors(scene.images, kp)),
        tables=tuple(np.asarray(a) for a in (ft_a, ft_b, vt_strict)),
    )


def frontend_configs(config_module, detector: str, method: str = "bf"):
    """The V=6 config of either package (`config_module`: its config module)
    with another detector or matcher, at the ratio the CLI picks for it (0.9
    for the binary descriptors, 0.8 for SIFT)."""
    c = config_module
    return c.PipelineConfig(
        features=c.FeatureConfig(max_keypoints=V6_MAX_KEYPOINTS, detector=detector),
        matching=c.MatchConfig(ratio=0.8 if detector == "sift" else 0.9, method=method),
    )


# The LK-flow matcher cannot bridge the V=6 arc's baseline; its runs use
# four views of a narrower arc of the same room.
FLOW_SCENE = dict(V6_SCENE, n_views=4, ring_fraction=0.02)


@functools.lru_cache(maxsize=None)
def reference_v6_frontend(detector: str, method: str = "bf"):
    """The reference's SfMResult on the V=6 scene with another front end
    (`detector` "akaze" / "orb"), or on FLOW_SCENE with `method` "flow"."""
    import sfm_danpipeline_tpu.config as j_config
    from sfm_danpipeline_tpu.pipeline.sfm import SfMPipeline
    from sfm_danpipeline_tpu.utils.synthscene import make_courtyard_scene

    scene = make_courtyard_scene(**(FLOW_SCENE if method == "flow" else V6_SCENE))
    res = SfMPipeline(frontend_configs(j_config, detector, method)).run(
        scene.images, scene.intrinsics
    )
    return SimpleNamespace(scene=scene, result=res)


def check_front_end(detector: str, method: str) -> None:
    """Both packages' SfMPipeline.run with this front end, held as the
    module docstring of tests/test_torch_frontends.py says."""
    import sfm_danpipeline_torch.config as t_config
    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline

    ref = reference_v6_frontend(detector, method)
    res = SfMPipeline(frontend_configs(t_config, detector, method), device="cpu").run(
        ref.scene.images, ref.scene.intrinsics
    )
    mj, mt = ref.result.metrics, res.metrics
    n_views = ref.scene.images.n_images
    assert mt["n_registered"] == mj["n_registered"] == n_views
    assert sorted(res.registered_views) == sorted(ref.result.registered_views)
    assert mt["n_components"] == mj["n_components"] == 1
    assert abs(mt["n_keypoints_mean"] - mj["n_keypoints_mean"]) <= 0.01 * mj["n_keypoints_mean"]
    assert mj["ba_rms_px"] < 1.5 and mt["ba_rms_px"] < 1.5, (mj["ba_rms_px"], mt["ba_rms_px"])
    assert abs(mj["ba_rms_px"] - mt["ba_rms_px"]) < 0.3, (mj["ba_rms_px"], mt["ba_rms_px"])
    assert abs(mj["n_points"] - mt["n_points"]) <= 0.15 * mj["n_points"], (mj["n_points"], mt["n_points"])
    width = {"akaze": 512, "orb": 256, "sift": 128}[detector]
    assert res.keypoints.descriptors.shape == (n_views, 1024, width)
