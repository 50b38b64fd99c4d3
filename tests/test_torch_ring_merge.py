"""The port's Sim(3) merge of a secondary component against the JAX
reference's, on the reference's own inputs, on the CPU.

On a closed ring the pipeline seeds secondary components and merges each
into the main one by a gated Sim(3) (`merge_attempt_step`: cross-component
candidates, the reprojection-scored Sim(3) RANSAC, gate 1, triangulation
of the component's views, an intermediate BA, gate 2). Each test runs the
reference's SfMPipeline on a ring, captures its inputs to every merge
attempt (tools/ring_capture.py) and feeds them, with the reference's key
and so the same Sim(3) draws, to the port's merge step.
"""
import numpy as np
import pytest
import torch

from test_torch_ring import PORT, REFERENCE, RING50_SEEDS, _config, _pipeline, ring_capture
from torch_testing import one_torch_thread  # noqa: F401


def _hold_merges(n_views, box_filter, max_keypoints, seed):
    """Every merge attempt (one per secondary component) of the reference's
    run on the ring, its inputs fed to the port's merge_attempt_step with
    the reference's key, so the same Sim(3) draws: the same decision and
    Sim(3) inlier count, the scale and gate 1 within MERGE_SCALE_ATOL and
    MERGE_GATE1_ATOL_PX, and the cross tracks and, when both merge, the
    merged points within MERGE_COUNT_RTOL, with the same cameras
    registered. Returns the reference's stats of each attempt."""
    from sfm_danpipeline_tpu.pipeline import sfm as j_sfm
    from sfm_danpipeline_torch.pipeline.sfm import merge_attempt_step

    pipe, images, intrinsics, _ = _pipeline(REFERENCE, n_views, box_filter, max_keypoints, seed)
    step, got, err = ring_capture.capture(
        j_sfm, "_merge_attempt_step", lambda: pipe.run(images, intrinsics), lambda n, a: n, 0
    )
    assert err is None, err
    config = _config(PORT, max_keypoints, seed)
    refs = []
    for _, a in sorted(got.items()):
        want, stats = step(*a)
        ref = ring_capture.merge_stats(stats)
        out, port = merge_attempt_step(**ring_capture.merge_args(a, config))
        for k in ("accepted", "sim_ok", "n_sim_inliers"):
            assert port[k] == ref[k], (k, port, ref)
        assert abs(port["scale"] - ref["scale"]) <= MERGE_SCALE_ATOL, (port, ref)
        if ref["med_gate1_px"] == float("inf"):
            assert port["med_gate1_px"] == float("inf"), (port, ref)
        else:
            assert abs(port["med_gate1_px"] - ref["med_gate1_px"]) <= MERGE_GATE1_ATOL_PX, (port, ref)
        assert abs(port["n_cross_tracks"] - ref["n_cross_tracks"]) <= MERGE_COUNT_RTOL * ref["n_cross_tracks"]
        if ref["accepted"]:
            assert torch.equal(out.camera_valid, torch.as_tensor(np.asarray(want.camera_valid)))
            n_ref = int(np.asarray(want.points_valid).sum())
            assert abs(int(out.points_valid.sum()) - n_ref) <= MERGE_COUNT_RTOL * n_ref
        refs.append(ref)
    return refs


# What one merge attempt on equal inputs and draws may part by (50-view
# ring, `tools/seed_parity.py merge-step --seed S [--ulps 3]`, CPU runs).
# The decision and the Sim(3) inlier count come out equal at every attempt
# of seeds 0-2; the reference keeps the scale and the gate medians in
# thousandths, truncated, and the scale agrees to that. Gate 1, the median
# reprojection of the fused points in the component's views right after the
# Sim(3), agrees within 3e-3 px but at seed 0's third attempt, component
# [11, 13, 14], whose cameras turn by 159-180 degrees there (angle-axis
# norm), where the port reads 0.4024 px against the reference's 0.4100.
# Gate 2 follows the intermediate BA and is not held: at that attempt a
# rounding step of the BA's input moves it further than the packages part
# (every point scaled by 1 + k * 1e-7, |k| <= 3: final cost 7,231-7,698 and
# gate 2 0.062-0.939 px in the reference, 7,516-7,908 and 0.062-0.137 px in
# the port), so only the decision is held, with the counts that follow it
# (cross tracks 1,096 against 1,095, points 5,223 against 5,222).
MERGE_SCALE_ATOL = 2e-3
MERGE_GATE1_ATOL_PX = 2e-2
MERGE_COUNT_RTOL = 5e-3


def test_ring24_merge_on_reference_inputs():
    """The 24-view ring's one secondary component, [0, 1, 15-23], lies
    across the ring from the main one: the Sim(3) RANSAC keeps 4 inliers
    (fewer than its 8) at scale 2.18 in the reference, and the port on the
    same inputs and draws must count the same and drop the component."""
    (ref,) = _hold_merges(24, True, 1024, 0)
    assert not ref["sim_ok"] and ref["n_sim_inliers"] == 4


@pytest.mark.slow
@pytest.mark.parametrize("seed", RING50_SEEDS)
def test_ring50_merges_on_reference_inputs(seed):
    """Every merge attempt of the reference's 50-view ring run at `seed`,
    each on its own inputs (two or three: component (2, 3) merges at seed 1
    only, and at every seed another component merges)."""
    refs = _hold_merges(50, False, 2048, seed)
    assert len(refs) >= 2 and any(r["accepted"] for r in refs)
