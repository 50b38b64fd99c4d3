"""The port's multi-process driver (sfm_danpipeline_torch.parallel.
distributed) in two gloo processes on the CPU, against the single-process
port and the JAX reference.

Each case starts two ranks of tests/torch_dist_worker.py (torch and the port
only; they check that they never import JAX), which meet at a file://
rendezvous in the test's temporary directory, so parallel test workers
never share a port. Tolerances:
  - run_ba_multihost: those of tests/test_multihost.py's worker (final cost
    within 2% of the single-process solve's, cameras within 0.2: with one
    camera pinned the problem keeps a scale gauge, and the ranks' sums add
    in another order than one process's); both ranks equal bit for bit;
  - features and matches gathered from the ranks: equal bit for bit to the
    single-process calls;
  - run_sfm_multihost: every view registered, both ranks' reconstructions
    equal bit for bit, the polish cost not increased, and at the default
    ba.sharded_min_obs the polish's early return recorded.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sfm_danpipeline_tpu.ba.problem import make_problem
from sfm_danpipeline_tpu.ba.solver import run_ba as j_run_ba
from sfm_danpipeline_tpu.config import BAConfig as JBAConfig
from sfm_danpipeline_torch.ba.solver import run_ba
from sfm_danpipeline_torch.config import BAConfig
from torch_dist_worker import (
    DIST_SCENE,
    ba_problem_numpy,
    dist_config,
    torch_problem,
)
from torch_testing import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")


def _two_ranks(case, tmp_path, timeout=240):
    """Run CASE on two ranks; returns each rank's saved arrays."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    init = "file://" + str(tmp_path / "rendezvous")
    prefix = str(tmp_path / case)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, case, init, "2", str(r), prefix],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        )
        for r in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        assert f"rank {r}: OK" in out
    return [dict(np.load(f"{prefix}.rank{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def ba_ranks(tmp_path_factory):
    return _two_ranks("ba", tmp_path_factory.mktemp("ba"))


@pytest.fixture(scope="module")
def sfm_ranks(tmp_path_factory):
    return _two_ranks("sfm", tmp_path_factory.mktemp("sfm"), timeout=400)


def test_ranks_use_gloo_on_the_cpu(ba_ranks):
    assert [str(r["backend"]) for r in ba_ranks] == ["gloo", "gloo"]


def test_host_shard_blocks(ba_ranks):
    assert [r["host_shard"].tolist() for r in ba_ranks] == [[0, 4], [4, 7]]


def test_run_ba_multihost_ranks_agree_bit_for_bit(ba_ranks):
    a, b = ba_ranks
    for k in ("cameras", "points", "final_cost", "initial_cost", "iterations"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_run_ba_multihost_matches_single_process_and_reference(ba_ranks):
    fields = ba_problem_numpy()
    single = run_ba(torch_problem(fields), BAConfig(max_iterations=40))
    ref = j_run_ba(
        make_problem(**{k: v for k, v in fields.items() if k != "fix_focal"}),
        JBAConfig(max_iterations=40),
    )
    mh = ba_ranks[0]
    c_mh = float(mh["final_cost"])
    assert c_mh < float(mh["initial_cost"])
    for cost, cams in (
        (float(single.final_cost), single.cameras.numpy()),
        (float(ref.final_cost), np.asarray(ref.cameras)),
    ):
        assert abs(c_mh - cost) < 0.02 * max(cost, 1.0), (c_mh, cost)
        assert float(np.abs(mh["cameras"] - cams).max()) < 0.2


def _single_process_inputs():
    from sfm_danpipeline_torch.ops.matching import match_all_pairs
    from sfm_danpipeline_torch.ops.sift import detect_and_compute_batch
    from sfm_danpipeline_torch.pipeline.sfm import _pair_list
    from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene

    scene = make_courtyard_scene(**DIST_SCENE)
    cfg = dist_config()
    kp = detect_and_compute_batch(torch.as_tensor(scene.images.gray), cfg.features)
    pi, pj = (torch.as_tensor(a, dtype=torch.int32) for a in _pair_list(scene.images.n_images))
    m = match_all_pairs(
        kp.descriptors, kp.valid, pi, pj,
        ratio=max(cfg.matching.ratio, cfg.matching.registration_ratio),
        max_matches=cfg.matching.max_matches, strict_ratio=cfg.matching.ratio, xy=kp.xy,
        dup_radius=cfg.matching.dup_radius, dedup=cfg.matching.dedup_matches,
    )
    return kp, m


def test_sharded_inputs_equal_single_process(sfm_ranks):
    kp, m = _single_process_inputs()
    for rank in sfm_ranks:
        for f in ("xy", "descriptors", "valid"):
            np.testing.assert_array_equal(rank[f"kp_{f}"], getattr(kp, f).numpy(), err_msg=f)
        for f in ("idx_a", "idx_b", "valid", "dist", "lowe"):
            np.testing.assert_array_equal(rank[f"m_{f}"], getattr(m, f).numpy(), err_msg=f)


def test_run_sfm_multihost_ranks_agree_and_register_every_view(sfm_ranks):
    a, b = sfm_ranks
    assert a["registered"].tolist() == list(range(DIST_SCENE["n_views"]))
    for k in ("registered", "cameras", "points"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for r in sfm_ranks:
        m = json.loads(str(r["metrics"]))
        assert m["n_processes"] == 2.0 and m["dist_backend"] == "gloo"
        assert m["mh_polish_cost1"] <= m["mh_polish_cost0"]
        assert m["n_registered"] == DIST_SCENE["n_views"]
        assert m["ba_rms_px"] < 1.0


def test_polish_early_return_at_default_routing(sfm_ranks):
    cfg = dist_config()
    assert cfg.ba.sharded_min_obs >= 10000  # the production routing
    for r in sfm_ranks:
        m = json.loads(str(r["metrics_default_routing"]))
        assert m["mh_polish_skipped"] == 1.0
        assert m["mh_n_obs"] < cfg.ba.sharded_min_obs
        assert m["n_processes"] == 2.0


def test_pack_round_trip_and_checks():
    from sfm_danpipeline_torch.parallel.distributed import pack, unpack

    ts = [torch.arange(5, dtype=torch.int32), torch.tensor(2.5), torch.tensor([True, False])]
    buf = pack(ts)
    assert buf.dtype == torch.uint8 and buf.numel() == 16 + 20 + 4 + 2
    out = unpack(buf, [torch.zeros_like(t) for t in ts])
    for t, o in zip(ts, out):
        assert torch.equal(t, o)
    with pytest.raises(ValueError):
        unpack(buf[:-1], ts)  # short buffer
    with pytest.raises(ValueError):
        unpack(buf, [ts[0], ts[1].reshape(1), ts[2]])  # other layout


def test_cli_flags_route_through_the_multiprocess_driver(tmp_path, monkeypatch):
    """--coordinator / --num-processes / --process-id: the process joins the
    job before the stages run, and the sfm stage runs run_sfm_multihost."""
    from sfm_danpipeline_torch import cli
    from sfm_danpipeline_torch.parallel import distributed as D
    from sfm_danpipeline_torch.pipeline.sfm import SfMResult
    from sfm_danpipeline_torch.pipeline.tracks import init_state

    PIL = pytest.importorskip("PIL.Image")
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for i in range(2):
        PIL.fromarray(np.full((8, 8, 3), 40 * i, np.uint8)).save(img_dir / f"{i}.png")
    calib = tmp_path / "calib.xml"
    calib.write_text(
        '<?xml version="1.0"?><opencv_storage><Camera_Matrix type_id="opencv-matrix">'
        "<rows>3</rows><cols>3</cols><dt>d</dt><data>100 0 4 0 100 4 0 0 1</data>"
        '</Camera_Matrix><Distortion_Coefficients type_id="opencv-matrix"><rows>5</rows>'
        "<cols>1</cols><dt>d</dt><data>0 0 0 0 0</data></Distortion_Coefficients>"
        "</opencv_storage>"
    )
    seen = []

    def fake_initialize(coordinator, num_processes, process_id, device):
        seen.append(("initialize", coordinator, num_processes, process_id, str(device)))
        return torch.device("cpu")

    def fake_run(images, intrinsics, cfg, run_ba_every_view, checkpoint_path, device):
        seen.append(("run_sfm_multihost", images.n_images, cfg.ba.sharded_min_obs, str(device)))
        st = init_state(images.n_images, cfg.features.max_keypoints, 8, 100.0)
        return SfMResult(
            state=st, keypoints=None, points=np.zeros((0, 3), np.float32),
            colors=np.zeros((0, 3), np.float32), registered_views=[0, 1],
            metrics={"dist_backend": "gloo"},
        )

    monkeypatch.setattr(D, "initialize", fake_initialize)
    monkeypatch.setattr(D, "run_sfm_multihost", fake_run)
    monkeypatch.setattr(D, "shutdown", lambda: seen.append(("shutdown",)))
    code = cli.main([
        "--images", str(img_dir), "--calibration", str(calib), "--output", str(tmp_path / "out"),
        "--stages", "sfm", "--device", "cpu", "--coordinator", "localhost:1234",
        "--num-processes", "2", "--process-id", "1", "--sharded-min-obs", "16",
    ])
    assert code == 0
    assert seen == [
        ("initialize", "localhost:1234", 2, 1, "cpu"),
        ("run_sfm_multihost", 2, 16, "cpu"),
        ("shutdown",),
    ]
    args = cli.build_parser().parse_args(["--images", "x", "--calibration", "y"])
    assert args.coordinator is None and cli.config_from_args(args).ba.sharded_min_obs == 50000
    with pytest.raises(SystemExit):
        cli.main(["--images", "x", "--calibration", "y", "--device", "cpu", "--coordinator", "h:1"])
