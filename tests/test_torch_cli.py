"""The port's checkpoints and command line: checkpoint files shared with the
JAX package, resume, and `python -m sfm_danpipeline_torch.cli` end to end on
the CPU.

Checkpoints: one .npz with the reference's field names, so a file written by
either package loads in the other, field for field (exact: the arrays are
stored, not recomputed). A run killed after its fourth view and resumed from
the per-view checkpoint ends with the uninterrupted run's registered set and
the same final RMS bit for bit: the CPU path is deterministic and the
checkpoint carries the RANSAC key counter `key_n`; a checkpoint without it
is refused.

The CLI runs on a V=6 scene written as 240x320 PNGs with `--device cpu` and
every stage. The scene is the 480x640 courtyard arc box-filtered to half
size (focal 260 px, a 63-degree field of view): at the renderer's own focal
length a 240x320 frame is too narrow for the rectified dense sweep, and the
dense, filter and mesh stages would have nothing to work on.
"""
import json
import os

import numpy as np
import pytest
import torch

from sfm_danpipeline_tpu.cli import build_parser as j_build_parser
from sfm_danpipeline_tpu.pipeline.tracks import ReconstructionState as JState
from sfm_danpipeline_tpu.utils import checkpoint as j_ckpt
from sfm_danpipeline_torch import cli, interop
from sfm_danpipeline_torch.config import FeatureConfig, PipelineConfig
from sfm_danpipeline_torch.io.native import read_ply_fast
from sfm_danpipeline_torch.io.ply import read_pcd, read_ply
from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline
from sfm_danpipeline_torch.pipeline.tracks import observation_table_compact
from sfm_danpipeline_torch.utils import checkpoint as t_ckpt
from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene
from torch_testing import one_torch_thread  # noqa: F401
from torch_v6_reference import STATE_FIELDS, V6_MAX_KEYPOINTS, V6_SCENE


def _toy_state_np(P=64, V=4, K=32, seed=0):
    rng = np.random.default_rng(seed)
    n = P // 2
    valid = np.zeros(P, bool)
    valid[:n] = True
    track = np.full((P, V), -1, np.int32)
    track[:n, 0] = np.arange(n) % K
    track[:n, 1] = (np.arange(n) + 3) % K
    inv = np.full((V, K), -1, np.int32)
    for p in range(n):
        inv[0, track[p, 0]] = p
    pts = rng.normal(0, 1, (P, 3)).astype(np.float32)
    pts[:, 2] += 4
    return dict(
        points_xyz=pts, points_rgb=rng.uniform(0, 1, (P, 3)).astype(np.float32),
        points_valid=valid, track_feat=track, feat_to_point=inv,
        cameras=rng.normal(0, 0.1, (V, 6)).astype(np.float32),
        camera_valid=np.array([True, True, False, False]),
        focal=np.float32(800.0), n_points=np.int32(n),
    )


def _assert_fields_equal(a_np, b_np):
    for f in STATE_FIELDS:
        assert a_np[f].dtype == b_np[f].dtype, f
        np.testing.assert_array_equal(a_np[f], b_np[f], err_msg=f)


class TestCheckpoint:
    def test_reference_checkpoint_loads_in_port(self, tmp_path):
        import jax.numpy as jnp

        st = _toy_state_np()
        path = str(tmp_path / "j.npz")
        j_ckpt.save_state(
            path, JState(**{k: jnp.asarray(v) for k, v in st.items()}),
            done=np.array([0, 1], np.int32), lost=np.zeros(0, np.int32), anchor=np.int32(0),
        )
        loaded, extra = t_ckpt.load_state(path, device="cpu")
        _assert_fields_equal(interop.state_to_numpy(loaded), st)
        np.testing.assert_array_equal(extra["done"], [0, 1])
        assert int(extra["anchor"]) == 0 and extra["lost"].size == 0

    def test_port_checkpoint_loads_in_reference(self, tmp_path):
        st = _toy_state_np(seed=1)
        path = str(tmp_path / "t.npz")
        t_ckpt.save_state(
            path, interop.state_from_numpy(st),
            done=np.array([0, 1], np.int32), lost=np.array([3], np.int32), anchor=np.int32(1),
        )
        loaded, extra = j_ckpt.load_state(path)
        _assert_fields_equal({f: np.asarray(getattr(loaded, f)) for f in STATE_FIELDS}, st)
        np.testing.assert_array_equal(extra["lost"], [3])
        assert int(extra["anchor"]) == 1

    def test_state_roundtrip(self, tmp_path):
        st = _toy_state_np()
        path = str(tmp_path / "ckpt.npz")
        t_ckpt.save_state(path, interop.state_from_numpy(st), done_views=np.array([0, 1]))
        loaded, extra = t_ckpt.load_state(path, device="cpu")
        _assert_fields_equal(interop.state_to_numpy(loaded), st)
        np.testing.assert_array_equal(extra["done_views"], [0, 1])

    def test_load_lands_on_the_card_unless_asked_for_the_cpu(self, tmp_path):
        path = str(tmp_path / "ckpt.npz")
        t_ckpt.save_state(path, interop.state_from_numpy(_toy_state_np()))
        assert t_ckpt.load_state(path, device="cpu")[0].device.type == "cpu"
        if torch.cuda.is_available():
            assert t_ckpt.load_state(path)[0].device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA card"):
                t_ckpt.load_state(path)

    def test_resume_continues_incremental(self, tmp_path):
        """A reloaded state is a drop-in for the live one: the observation
        table (the BA / PnP input) is identical."""
        state = interop.state_from_numpy(_toy_state_np())
        path = str(tmp_path / "ckpt.npz")
        t_ckpt.save_state(path, state)
        loaded, _ = t_ckpt.load_state(path, device="cpu")
        kp_xy = torch.tensor(
            np.random.default_rng(1).uniform(0, 100, (4, 32, 2)), dtype=torch.float32
        )
        pp = torch.tensor([50.0, 50.0])
        n = int(state.n_points)
        for a, b in zip(
            observation_table_compact(state, kp_xy, pp, n_points=n),
            observation_table_compact(loaded, kp_xy, pp, n_points=n),
        ):
            assert torch.equal(a, b)


def test_mid_run_kill_and_resume(tmp_path):
    """A fresh pipeline object started on the per-view checkpoint as it was
    after the 4th view (what a kill at that moment leaves on disk) ends as
    the uninterrupted run does."""
    import shutil

    scene = make_courtyard_scene(**V6_SCENE)
    cfg = PipelineConfig(features=FeatureConfig(max_keypoints=V6_MAX_KEYPOINTS))
    ckpt, cut = str(tmp_path / "full.npz"), str(tmp_path / "cut.npz")
    pipe = SfMPipeline(cfg, checkpoint_path=ckpt, device="cpu")
    orig = pipe._save_ckpt

    def save_and_copy(state, done, anchor):
        orig(state, done, anchor)
        if len(done) == 4:
            shutil.copy(ckpt, cut)

    pipe._save_ckpt = save_and_copy
    full = pipe.run(scene.images, scene.intrinsics)
    with np.load(cut) as z:
        assert z["track_feat"].shape == (cfg.max_points, 6)
        assert len(z["extra_done"]) == 4
    res = SfMPipeline(cfg, checkpoint_path=cut, device="cpu").run(scene.images, scene.intrinsics)
    assert res.registered_views == full.registered_views == list(range(6))
    assert res.metrics["n_points"] == full.metrics["n_points"]
    assert res.metrics["ba_rms_px"] == full.metrics["ba_rms_px"]  # bit for bit on the CPU
    assert torch.equal(res.state.cameras, full.state.cameras)
    # A checkpoint whose shapes do not fit the config is ignored, not loaded.
    other = PipelineConfig(max_points=4096, features=FeatureConfig(max_keypoints=V6_MAX_KEYPOINTS))
    assert SfMPipeline(other, checkpoint_path=cut, device="cpu")._load_ckpt(6) is None


def test_resume_refuses_a_checkpoint_without_key_n(tmp_path):
    """A checkpoint without the RANSAC key counter (the reference's, or an
    older port's) would resume on other draws than the run that wrote it:
    it is refused, naming the field, and resumed with it."""
    from sfm_danpipeline_torch.pipeline.tracks import init_state

    cfg = PipelineConfig(max_points=256, features=FeatureConfig(max_keypoints=64))
    path = str(tmp_path / "ckpt.npz")
    extras = dict(done=np.array([0, 1], np.int32), lost=np.zeros(0, np.int32), anchor=np.int32(0))
    t_ckpt.save_state(path, init_state(4, 64, 256, 500.0, device="cpu"), **extras)
    pipe = SfMPipeline(cfg, checkpoint_path=path, device="cpu")
    with pytest.raises(ValueError, match="key_n"):
        pipe._load_ckpt(4)
    t_ckpt.save_state(path, init_state(4, 64, 256, 500.0, device="cpu"), key_n=np.int64(7), **extras)
    _, done, _, _, key_n = pipe._load_ckpt(4)
    assert done == {0, 1} and key_n == 7


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


def test_parser_has_the_reference_flags_plus_device():
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}

    # Beyond the reference: --device, and --sharded-min-obs (the size from
    # which the multi-process polish runs sharded, a config field the
    # reference's command line cannot set).
    assert flags(cli.build_parser()) == flags(j_build_parser()) | {"--device", "--sharded-min-obs"}
    ja = j_build_parser().parse_args(["--images", "a", "--calibration", "b"])
    ta = cli.build_parser().parse_args(["--images", "a", "--calibration", "b"])
    for k, v in vars(ja).items():
        assert getattr(ta, k) == v, k
    assert ta.device == "cuda"
    for det, ratio in (("sift", 0.8), ("akaze", 0.9), ("orb", 0.9)):
        args = cli.build_parser().parse_args(["--images", "a", "--calibration", "b", "--detector", det])
        assert cli.config_from_args(args).matching.ratio == ratio


def _write_scene(tmp_path, images, intrinsics):
    from PIL import Image

    d = tmp_path / "images"
    d.mkdir()
    for i, im in enumerate(images.color):
        Image.fromarray(np.clip(np.round(im * 255), 0, 255).astype(np.uint8)).save(d / f"view_{i:03d}.png")
    K = intrinsics.K
    xml = tmp_path / "calib.xml"
    xml.write_text(
        '<?xml version="1.0"?>\n<opencv_storage>\n'
        '<Camera_Matrix type_id="opencv-matrix"><rows>3</rows><cols>3</cols><dt>d</dt>\n'
        f"<data>{' '.join(repr(float(v)) for v in K.reshape(-1))}</data></Camera_Matrix>\n"
        '<Distortion_Coefficients type_id="opencv-matrix"><rows>1</rows><cols>5</cols><dt>d</dt>\n'
        "<data>0. 0. 0. 0. 0.</data></Distortion_Coefficients>\n</opencv_storage>\n"
    )
    return str(d), str(xml)


@pytest.fixture(scope="module")
def half_size_scene():
    """The V=6 courtyard arc at 480x640, box-filtered to 240x320 (focal 260)."""
    scene = make_courtyard_scene(**dict(V6_SCENE, height=480, width=640))

    def half(a):
        return 0.25 * (a[:, 0::2, 0::2] + a[:, 1::2, 0::2] + a[:, 0::2, 1::2] + a[:, 1::2, 1::2])

    import dataclasses

    images = dataclasses.replace(
        scene.images, gray=half(scene.images.gray), color=half(scene.images.color),
        sizes=scene.images.sizes // 2,
    )
    return images, scene.intrinsics.scaled(0.5)


def _records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return {r["stage"]: r for r in map(json.loads, f)}


@pytest.mark.parametrize("detector", ["akaze", "orb"])
def test_full_cli_writes_every_artifact(tmp_path, half_size_scene, detector):
    images, intrinsics = half_size_scene
    img_dir, xml = _write_scene(tmp_path, images, intrinsics)
    out = str(tmp_path / "out")
    ckpt = str(tmp_path / "state.npz")
    rc = cli.main([
        "--images", img_dir, "--calibration", xml, "--output", out, "--device", "cpu",
        "--stages", "sfm,dense,filter,mesh,segment,dendrometry", "--detector", detector,
        "--max-keypoints", "1024", "--checkpoint", ckpt,
    ] + (["--viz"] if detector == "orb" else []))
    assert rc == 0
    rec = _records(out)
    assert set(rec) == {"sfm", "dense", "filter", "mesh", "segment", "dendrometry", "timing", "trace"}
    assert rec["sfm"]["n_registered"] == 6 and rec["sfm"]["ba_rms_px"] < 1.0
    # The run's trace: one root "set", the six stage spans under it, whose
    # durations are the sfm record's t_* timers, and the counters.
    spans, counters = rec["trace"]["spans"], rec["trace"]["counters"]
    assert [s["name"] for s in spans if s["parent"] == -1] == ["set"]
    stages = {s["name"]: s for s in spans if s["parent"] == spans[0]["index"]}
    assert list(stages) == ["features", "matching", "baseline", "incremental", "components", "final_ba"]
    for name, s in stages.items():
        assert (s["end_ns"] - s["start_ns"]) / 1e9 == rec["sfm"]["t_" + name]
    assert counters["pnp_attempts"] >= 4 and counters["seed_basins"] >= 1
    assert counters["lm_iterations"] >= counters["ba_solves"] >= 1
    pts, cols = read_ply(os.path.join(out, "sparse.ply"))
    assert len(pts) == rec["sfm"]["n_points"] and cols.shape == pts.shape
    with open(os.path.join(out, "cameras.json")) as f:
        cams = json.load(f)
    assert cams["registered_views"] == list(range(6)) and np.asarray(cams["cameras"]).shape == (6, 6)
    n_dense = int(rec["dense"]["n_dense_points"])
    assert n_dense > 1000 and rec["dense"]["depth_coverage"] > 0.2
    assert len(read_ply_fast(os.path.join(out, "dense.ply"))[0]) == n_dense
    assert len(read_pcd(os.path.join(out, "MAP3D.pcd"))[0]) == n_dense
    assert rec["filter"]["n_before"] == n_dense and 0 < rec["filter"]["n_after"] <= n_dense
    assert len(read_ply(os.path.join(out, "filtered.ply"))[0]) == rec["filter"]["n_after"]
    with open(os.path.join(out, "mesh.obj")) as f:
        lines = f.read().splitlines()
    assert sum(l.startswith("f ") for l in lines) == rec["mesh"]["n_faces"] > 0
    assert sum(l.startswith("v ") for l in lines) == rec["mesh"]["n_vertices"]
    labels = np.load(os.path.join(out, "segmentation_labels.npy"))
    assert labels.shape == (rec["filter"]["n_after"],) and labels.dtype == np.int32
    assert rec["segment"]["n_clusters"] >= 1 and (labels >= 0).any()
    with open(os.path.join(out, "dendrometry.json")) as f:
        rep = json.load(f)
    assert rep["total_height"] > 0 and rep["n_points"] == rec["filter"]["n_after"]
    assert {"t_sfm", "t_dense"} <= set(rec["timing"])

    if detector == "orb":  # ran with --viz
        viz = sorted(os.listdir(os.path.join(out, "viz")))
        assert [f for f in viz if f.startswith("keypoints_")] == [f"keypoints_{i:04d}.png" for i in range(6)]
        assert [f for f in viz if f.startswith("depth_")] == [f"depth_{i:04d}.png" for i in range(6)]
        assert {"sparse_cloud.png", "dense_cloud.png"} <= set(viz)
        assert sum(f.startswith("matches_") for f in viz) == 1
    if detector == "akaze":
        # The CLI's resume path: later stages from the checkpoint alone.
        out2 = str(tmp_path / "out2")
        rc = cli.main([
            "--images", img_dir, "--calibration", xml, "--output", out2, "--device", "cpu",
            "--stages", "dense,dendrometry", "--checkpoint", ckpt,
        ])
        assert rc == 0
        rec2 = _records(out2)
        assert "sfm" not in rec2
        assert rec2["dense"]["n_dense_points"] == rec["dense"]["n_dense_points"]


def test_analysis_from_checkpoint(tmp_path):
    """`--stages dendrometry` with a checkpoint runs the analysis tail
    without redoing SfM."""
    scene = make_courtyard_scene(n_views=2, height=48, width=64, ring_fraction=0.05, seed=0)
    img_dir, xml = _write_scene(tmp_path, scene.images, scene.intrinsics)
    ckpt = str(tmp_path / "state.npz")
    t_ckpt.save_state(ckpt, interop.state_from_numpy(_toy_state_np(P=256, V=4, K=64)))
    out = str(tmp_path / "out")
    rc = cli.main([
        "--images", img_dir, "--calibration", xml, "--output", out,
        "--stages", "dendrometry", "--checkpoint", ckpt, "--device", "cpu",
    ])
    assert rc == 0
    with open(os.path.join(out, "dendrometry.json")) as f:
        assert json.load(f)["total_height"] > 0


def test_no_cloud_is_exit_code_one(tmp_path):
    scene = make_courtyard_scene(n_views=2, height=48, width=64, ring_fraction=0.05, seed=0)
    img_dir, xml = _write_scene(tmp_path, scene.images, scene.intrinsics)
    args = ["--images", img_dir, "--calibration", xml, "--output", str(tmp_path / "o"), "--device", "cpu"]
    assert cli.main(args + ["--stages", "dendrometry"]) == 1
    assert cli.main(args + ["--stages", "dense"]) == 1  # needs sfm or a checkpoint


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    args = ["--images", str(tmp_path), "--calibration", str(tmp_path / "c.xml"), "--output", str(tmp_path / "o")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            cli.main(args)
    # Multi-process mode needs the job's size and this process's rank.
    with pytest.raises(SystemExit, match="--num-processes and --process-id"):
        cli.main(args + ["--device", "cpu", "--coordinator", "localhost:1234"])
    with pytest.raises(ValueError, match="unknown stage"):
        cli.run_stages(None, None, PipelineConfig(), str(tmp_path / "o"), ["sfm", "polish"], device="cpu")
