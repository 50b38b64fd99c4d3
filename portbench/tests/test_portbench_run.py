"""A run of the harness on the CPU at a small size, with the look for a card
skipped: the result line's shape, no module of JAX or the JAX package
loaded, and `correct` false when the timed path is broken underneath.

The small cell (6 views at 240x320, 1,024 keypoints, the sizes of the
repository's CPU parity tests) is added as files to a copy of the benchmark,
with limits of its own: the real cells' limits hold the real sizes, where
the reconstruction is tighter.
"""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.harness import Bench, run_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "tiny6.sparse"
# The real cells' limits, but for ATE: the small cell's sound run (seed 7)
# reads ATE 2.7%, RMS 0.15 px, 635 points, BA excess 4e-9 px^2.
TINY_LIMITS = {"views_missing": {"max": 0}, "ate_pct": {"max": 5.0}, "reproj_rms_px": {"max": 1.0},
               "n_points": {"min": 300}, "ba_excess_px2": {"max": 3e-3}}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench")
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec["configs"].append({"name": "tiny6", "source": "https://example.org/tiny6",
                            "file": "portbench/configs/tiny6.json", "reduced": ["n_views"], "why": "test"})
    spec["workloads"].append({"name": CELL, "config": "tiny6", "traffic": "sparse", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "portbench" / "configs" / "tiny6.json").write_text(json.dumps({
        "scene": {"n_views": 6, "ring_fraction": 0.12, "height": 240, "width": 320},
        "pipeline": {"features.max_keypoints": 1024},
    }))
    (root / "portbench" / "limits" / f"{CELL}.json").write_text(json.dumps({"limits": TINY_LIMITS}))
    (root / "portbench" / "traffic" / "sparse.json").write_text(json.dumps({"warmup_sets": 0}))
    return str(root)


def _run(root, trace=False):
    return run_cell(Bench(root), CELL, seed=7, seconds=0.0, trace=trace, device="cpu")


def test_cpu_run_is_correct_and_loads_no_jax(tiny_root):
    """In a process of its own, so that sys.modules holds only what the
    harness and the program loaded."""
    code = (
        "import json, sys; sys.path.insert(0, {repo!r})\n"
        "from portbench.harness import Bench, run_cell, forbidden_modules\n"
        "result, checks = run_cell(Bench({root!r}), {cell!r}, 7, 0.0, True, device='cpu')\n"
        "print(json.dumps(dict(result=result, checks=checks, forbidden=forbidden_modules(),"
        " torch_port=[m for m in sys.modules if m.split('.')[0] == 'sfm_danpipeline_torch'][:1])))\n"
    ).format(repo=ROOT, root=tiny_root, cell=CELL)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == [] and got["torch_port"], got
    result = got["result"]
    assert result["correct"] is True and result["attempted"] == 1 and result["failed"] == 0, got["checks"]
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert {"features_s", "matching_s", "baseline_s", "incremental_s", "final_ba_s"} <= set(result["metrics"])
    assert "knn2_roofline" not in result["metrics"]
    assert result["device"]["platform"] == "cpu"


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    from portbench.harness import forbidden_modules

    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    monkeypatch.setitem(sys.modules, "sfm_danpipeline_tpu_x", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sfm_danpipeline_tpu.ops", sys)
    assert forbidden_modules() == ["sfm_danpipeline_tpu.ops"]


def _ba_unchanged(monkeypatch):
    """Every bundle adjustment returns the state it was given."""
    from sfm_danpipeline_torch.pipeline import sfm

    real = sfm.run_ba
    monkeypatch.setattr(sfm, "run_ba", lambda prob, cfg, max_iterations=None: real(prob, cfg, max_iterations=0))


def _half_the_images(monkeypatch):
    """Half of the batch left out: every other image's keypoints dropped."""
    import dataclasses

    from sfm_danpipeline_torch.pipeline import sfm

    real = sfm.detect_and_compute_batch

    def half(gray, config):
        kp = real(gray, config)
        valid = kp.valid.clone()
        valid[1::2] = False
        return dataclasses.replace(kp, valid=valid)

    monkeypatch.setattr(sfm, "detect_and_compute_batch", half)


def _camera_altered(monkeypatch):
    """An answer altered where it is produced: one camera of the returned
    reconstruction turned by 0.05 rad."""
    from sfm_danpipeline_torch.pipeline import sfm

    real = sfm.SfMPipeline.run

    def run(self, *a, **kw):
        res = real(self, *a, **kw)
        res.state.cameras[2, 1] += 0.05
        return res

    monkeypatch.setattr(sfm.SfMPipeline, "run", run)


@pytest.mark.parametrize("fault", [_ba_unchanged, _half_the_images, _camera_altered], ids=lambda f: f.__name__[1:])
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    torch.manual_seed(0)
    fault(monkeypatch)
    result, checks = _run(tiny_root)
    assert result["correct"] is False and result["failed"] == 1, checks
