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
    """Scene, config, the reference's SfMResult, its state as numpy, and
    the reference's match tables for the same keypoints."""
    import jax.numpy as jnp

    from sfm_danpipeline_tpu.config import FeatureConfig, PipelineConfig
    from sfm_danpipeline_tpu.ops.matching import match_all_pairs
    from sfm_danpipeline_tpu.pipeline.incremental import build_match_tables
    from sfm_danpipeline_tpu.pipeline.sfm import SfMPipeline, _keypoint_colors, _pair_list
    from sfm_danpipeline_tpu.utils.synthscene import make_courtyard_scene

    scene = make_courtyard_scene(**V6_SCENE)
    cfg = PipelineConfig(features=FeatureConfig(max_keypoints=V6_MAX_KEYPOINTS))
    res = SfMPipeline(cfg).run(scene.images, scene.intrinsics)
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
        scene=scene, config=cfg, result=res, pi=pi, pj=pj, strict=strict,
        state={k: np.asarray(getattr(res.state, k)) for k in STATE_FIELDS},
        keypoints_xy=np.asarray(kp.xy),
        colors=np.asarray(_keypoint_colors(scene.images, kp)),
        tables=tuple(np.asarray(a) for a in (ft_a, ft_b, vt_strict)),
    )
