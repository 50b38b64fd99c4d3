"""Seed for seed: both packages' `SfMPipeline.run` on the V=6 rendered
courtyard of tests/test_torch_slice.py (240x320, ring_fraction 0.12,
max_keypoints 1024, otherwise the default config) at geometry.seed 0, 1
and 2 (0-4 in a slow twin).

One seed gives both packages the same RANSAC draws (the reference's
threefry key tree, ops/prng.py), taken at the same places: each pair of
runs must register the same views and take the same number of
registration keys, and meet tests/test_torch_slice.py's tolerances (BA RMS
under 0.5 px on both sides and within 0.1 px of each other, ATE under 1% of
the trajectory diameter on both sides, point counts within 15%). The port
runs on the CPU with one intra-op thread.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from sfm_danpipeline_tpu.pipeline.sfm import SfMPipeline as JPipeline
from sfm_danpipeline_tpu.utils.metrics import camera_centers as j_centers
from sfm_danpipeline_torch.config import FeatureConfig, PipelineConfig
from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline
from sfm_danpipeline_torch.utils.metrics import aligned_rmse, camera_centers
from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene
from torch_v6_reference import V6_MAX_KEYPOINTS, V6_SCENE, reference_v6


def _with_seed(cfg, seed):
    return dataclasses.replace(cfg, geometry=dataclasses.replace(cfg.geometry, seed=seed))


@functools.lru_cache(maxsize=None)
def _seed_runs(seed):
    """Both packages' runs at geometry.seed = `seed` (seed 0's reference run
    is the shared one of torch_v6_reference.py)."""
    scene = make_courtyard_scene(**V6_SCENE)
    if seed == 0:
        ref = reference_v6()
        rj, j_keys = ref.result, ref.key_n
    else:
        jpipe = JPipeline(_with_seed(reference_v6().config, seed))
        rj = jpipe.run(scene.images, scene.intrinsics)
        j_keys = jpipe._key_n
    cfg = _with_seed(PipelineConfig(features=FeatureConfig(max_keypoints=V6_MAX_KEYPOINTS)), seed)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tpipe = SfMPipeline(cfg, device="cpu")
        rt = tpipe.run(scene.images, scene.intrinsics)
    finally:
        torch.set_num_threads(threads)
    out = {}
    for name, res, centers, n_keys in (
        ("jax", rj, j_centers(np.asarray(rj.state.cameras)), j_keys),
        ("torch", rt, camera_centers(rt.state.cameras.numpy()), tpipe._progress.key_n),
    ):
        regs = sorted(res.registered_views)
        g = scene.centers[regs]
        ate = aligned_rmse(centers[regs], g) / float(np.linalg.norm(g.max(0) - g.min(0)))
        out[name] = dict(res.metrics, ate_frac=ate, regs=regs, key_n=n_keys)
    return out


def _assert_same_outcome(r):
    j, t = r["jax"], r["torch"]
    assert t["regs"] == j["regs"], (t["regs"], j["regs"])
    assert t["key_n"] == j["key_n"], (t["key_n"], j["key_n"])
    assert j["ba_rms_px"] < 0.5 and t["ba_rms_px"] < 0.5, (j["ba_rms_px"], t["ba_rms_px"])
    assert abs(j["ba_rms_px"] - t["ba_rms_px"]) < 0.1, (j["ba_rms_px"], t["ba_rms_px"])
    assert j["ate_frac"] < 0.01 and t["ate_frac"] < 0.01, (j["ate_frac"], t["ate_frac"])
    assert abs(j["n_points"] - t["n_points"]) <= 0.15 * j["n_points"], (j["n_points"], t["n_points"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seed_for_seed(seed):
    """One seed, one set of draws: the same views registered, the same
    registration keys taken, and the quality within the slice's tolerances."""
    _assert_same_outcome(_seed_runs(seed))


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(5))
def test_seed_for_seed_over_five_seeds(seed):
    _assert_same_outcome(_seed_runs(seed))
