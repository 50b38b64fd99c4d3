"""The port against the JAX reference on closed rings of the rendered
courtyard, on the CPU.

The ring the users run is `make_courtyard_scene(n_views=50,
ring_fraction=1.0, seed=0)` at 480x640 with 2,048 keypoints: 1,225 pairs,
several secondary components, the Sim(3) gates, the straggler sweep, the
rotation-averaging reinit with its snapshot-and-compare accept and the
local-window BA over a long chain. There the two packages do not end alike
seed for seed: each run's outcome (which secondary component merges, and so
which views register) follows float32 rounding, in the reference too, whose
own outcome moves with XLA's thread count (`tools/seed_parity.py ring`,
PERF.md, ROADMAP Queue 3). What holds there, and what the `slow` twins
check at geometry seeds 0-2, is that both packages compute the same step:
the reference's inputs to one registration step (PnP, triangulation, BA)
fed to the port give the same PnP counts and points, and cameras and
points within a stated distance of the reference's
(tests/test_torch_ring_merge.py does the same for the Sim(3) merges).

The smaller rings are rendered at 480x640 and box-filtered to 240x320
(focal 260 px, the full frame's 63-degree field of view; a frame rendered
at 240x320 directly sees 34 degrees) with 1,024 keypoints. On a 24-view
ring both packages register 10 views (short of the reinit's 16) and, run
end to end at geometry seed 0, must register the same views from the same
seed pair, take the same number of registration keys, reach the same
rotation-averaging decision, and end within 0.1 px of final RMS and 2% of
the reference's point count; that run takes about six minutes for both
packages on a CPU, so it is `slow`, and the unmarked tests hold one step
of it on the reference's inputs and both packages end to end on a 12-view
ring, where neither finds a seed pair a third view registers against
(adjacent frames 30 degrees apart) and both take the same registration
keys trying.

The last test holds the repair the 50-view ring needed on the CPU.
"""
import dataclasses
import importlib
import os
import sys

import numpy as np
import pytest
import torch

from sfm_danpipeline_torch.ops import matching
from torch_testing import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import ring_capture  # noqa: E402

RING50_SEEDS = (0, 1, 2)


def _half(images):
    def half(a):
        return 0.25 * (a[:, 0::2, 0::2] + a[:, 1::2, 0::2] + a[:, 0::2, 1::2] + a[:, 1::2, 1::2])

    return dataclasses.replace(
        images, gray=half(images.gray), color=half(images.color), sizes=images.sizes // 2
    )


def _scene(make_courtyard_scene, n_views, box_filter):
    scene = make_courtyard_scene(n_views=n_views, ring_fraction=1.0, seed=0)
    if not box_filter:
        return scene.images, scene.intrinsics, scene.centers
    return _half(scene.images), scene.intrinsics.scaled(0.5), scene.centers


REFERENCE, PORT = "sfm_danpipeline_tpu", "sfm_danpipeline_torch"


def _config(package, max_keypoints, seed):
    c = importlib.import_module(package + ".config").PipelineConfig()
    return dataclasses.replace(
        c, features=dataclasses.replace(c.features, max_keypoints=max_keypoints),
        geometry=dataclasses.replace(c.geometry, seed=seed),
    )


def _pipeline(package, n_views, box_filter, max_keypoints, seed):
    """One package's SfMPipeline (the port's on the CPU) at `seed`, and the
    ring's images, intrinsics and ground-truth centres."""
    sfm = importlib.import_module(package + ".pipeline.sfm")
    synth = importlib.import_module(package + ".utils.synthscene")
    c = _config(package, max_keypoints, seed)
    pipe = sfm.SfMPipeline(c, **({"device": "cpu"} if package == PORT else {}))
    return (pipe,) + _scene(synth.make_courtyard_scene, n_views, box_filter)


def _outcome(package, n_views, box_filter, max_keypoints, seed):
    from sfm_danpipeline_torch.utils.metrics import aligned_rmse, camera_centers

    pipe, images, intrinsics, centers = _pipeline(package, n_views, box_filter, max_keypoints, seed)
    res = pipe.run(images, intrinsics)
    regs = sorted(res.registered_views)
    cams = res.state.cameras
    cams = cams.numpy() if package == PORT else np.asarray(cams, np.float32)
    gt = centers[regs]
    ate = aligned_rmse(camera_centers(cams)[regs], gt) / float(np.linalg.norm(gt.max(0) - gt.min(0)))
    m = res.metrics
    return dict(
        registered=regs, key_n=ring_capture.keys_taken(pipe), rms=m["ba_rms_px"], points=m["n_points"],
        ate=ate, seed_pair=(m["baseline_pair_i"], m["baseline_pair_j"]), rotavg_applied=m.get("rotavg_applied"),
    )


def _hold(ref, port):
    assert port["registered"] == ref["registered"]
    assert port["seed_pair"] == ref["seed_pair"]
    assert port["key_n"] == ref["key_n"]
    assert port["rotavg_applied"] == ref["rotavg_applied"]
    assert abs(port["rms"] - ref["rms"]) <= 0.1
    assert abs(port["points"] - ref["points"]) <= 0.02 * ref["points"]


def test_ring12_matches_reference():
    """Both packages take the same registration keys on the 12-view ring
    (the same seed pairs and basins tried) and find no seed pair a third
    view registers against."""
    keys = []
    for package in (REFERENCE, PORT):
        pipe, images, intrinsics, _ = _pipeline(package, 12, True, 1024, 0)
        with pytest.raises(RuntimeError, match="baseline reconstruction failed"):
            pipe.run(images, intrinsics)
        keys.append(ring_capture.keys_taken(pipe))
    assert keys[0] == keys[1] > 0


@pytest.mark.slow
def test_ring24_matches_reference():
    _hold(*(_outcome(p, 24, True, 1024, 0) for p in (REFERENCE, PORT)))


def _reference_calls(name, n_views, box_filter, max_keypoints, seed, calls):
    """The arguments of calls number `calls` (1-based) of the reference's
    jitted step `name` (`_register_adjust_step`, one call per view
    attempt, or `_merge_attempt_step`, one per secondary component) in its
    SfMPipeline.run on the ring, which stops after the last of them; and
    the step itself."""
    from sfm_danpipeline_tpu.pipeline import sfm as j_sfm

    pipe, images, intrinsics, _ = _pipeline(REFERENCE, n_views, box_filter, max_keypoints, seed)
    step, got, err = ring_capture.capture(
        j_sfm, name, lambda: pipe.run(images, intrinsics),
        lambda n, a: n if n in calls else None, len(calls),
    )
    assert err is None and len(got) == len(calls), err
    return step, [got[n] for n in calls]


def _hold_steps(n_views, box_filter, max_keypoints, seed, first, atol):
    """Registration steps `first` and `first + 1` of the reference's run on
    the ring, fed to the port: on the reference's inputs to the second, the
    port's PnP registration counts what the reference's counts; on its
    inputs to the first, the port's whole step (PnP, triangulation, BA)
    registers the view, keeps the same points and ends within `atol`
    (cameras, points) of the reference's state."""
    from sfm_danpipeline_torch.pipeline.incremental import register_view
    from sfm_danpipeline_torch.pipeline.sfm import register_adjust_step

    step, (a0, a1) = _reference_calls(
        "_register_adjust_step", n_views, box_filter, max_keypoints, seed, (first, first + 1)
    )
    config = _config(PORT, max_keypoints, seed)
    ref = [int(x) for x in np.asarray(step(*a1)[1])]
    p = ring_capture.step_args(a1, config)
    c = p["inputs"]
    _, ok, n_inl, n_sup = register_view(
        p["key"], p["state"], p["new_view"], p["done_views"], c.tables.feat_a, c.tables.feat_b,
        c.tables.loose, c.kp.xy, c.K, c.dist, c.max_dim, c.config, valid_tab_strict=c.tables.strict,
    )
    assert [int(ok), int(n_inl), int(n_sup)] == ref[:3]
    out, stats = register_adjust_step(**ring_capture.step_args(a0, config))
    want = p["state"]  # the jitted step's result: the reference's next input
    assert stats[0] == 1
    assert torch.equal(out.camera_valid, want.camera_valid)
    assert torch.equal(out.points_valid, want.points_valid)
    assert int(out.n_points) == int(want.n_points)
    cams, pts = want.camera_valid, want.points_valid

    def gap(a, b, mask):
        return float((torch.as_tensor(np.asarray(a))[mask] - b[mask]).abs().max())

    assert gap(out.cameras, want.cameras, cams) <= atol[0]
    assert gap(out.points_xyz, want.points_xyz, pts) <= atol[1]


# How far one step of the two packages may end apart (cameras: angle-axis
# and translation; points). On the 50-view ring's seed-1 step of view 36
# the port ends 9.5e-7 from the reference's cameras and 9.3e-5 from its
# points, while the reference's own step evaluated op by op
# (`jax.disable_jit`, another rounding of the same arithmetic) ends 8.6e-6
# and 4.1e-4 from them (`tools/seed_parity.py ring-step 35 --seed 1 --prev
# 36`, on a CPU). The 24-view ring is box-filtered to half size, where a
# step's BA is less well conditioned: on its step 2 (view 11, 4 cameras,
# 641 points) the port ends 2.6e-4 from the reference's cameras and 1.3e-3
# from its points, the reference op by op 2.9e-3 and 1.7e-2 (steps 3 and 4:
# port 7.4e-3 / 3.0e-2 and 5.5e-2 / 2.4, op by op 9.8e-2 / 0.39 and
# 3.3e-2 / 2.3; CPU runs). The limits are about four times the port's gaps
# and below the reference's own op-by-op spread.
RING24_STEP_ATOL = (1e-3, 5e-3)
RING50_STEP_ATOL = (1e-4, 1e-2)


def test_ring24_step_on_reference_inputs():
    _hold_steps(24, True, 1024, 0, 2, RING24_STEP_ATOL)


@pytest.mark.slow
@pytest.mark.parametrize("seed", RING50_SEEDS)
def test_ring50_step_on_reference_inputs(seed):
    _hold_steps(50, False, 2048, seed, 2, RING50_STEP_ATOL)


def test_cpu_knn2_runs_in_slices_of_pairs(monkeypatch):
    """knn2 on CPU tensors holds at most CPU_SLICE_BYTES of distances per
    knn2_torch call (the 50-view ring's 1,225 pairs at once took more than
    this machine's memory), and the slices give the one-call result bit for
    bit."""
    g = np.random.default_rng(0)
    n, k, d = 9, 64, 32
    desc = torch.tensor(g.standard_normal((n, k, d)), dtype=torch.float32)
    valid = torch.tensor(g.random((n, k)) > 0.1)
    xy = torch.tensor(g.random((n, k, 2)) * 8.0, dtype=torch.float32)
    pi, pj = (torch.tensor(a, dtype=torch.int32) for a in np.triu_indices(n, 1))
    whole = matching.knn2_torch(desc[pi.long()], desc[pj.long()], valid[pj.long()], xy[pj.long()], 0.25)

    sizes = []
    plain = matching.knn2_torch

    def recorded(a, *rest):
        sizes.append(a.shape[0])
        return plain(a, *rest)

    monkeypatch.setattr(matching, "knn2_torch", recorded)
    monkeypatch.setattr(matching, "CPU_SLICE_BYTES", 5 * 4 * k * k)
    got = matching.knn2(desc, valid, xy, pi, pj, 0.25)
    assert sizes == [5] * 7 + [1]
    for a, b in zip(got, whole):
        assert torch.equal(a, b)
