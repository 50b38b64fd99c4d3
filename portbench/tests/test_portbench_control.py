"""The check's controls on the card, at the cell's own size: with every
bundle adjustment returning the state it was given (`--control no-ba`), or
with knn2's second distance inflated so that the ratio test passes every
nearest neighbour (`--control no-ratio`), the check fails every set, on the
number that covers the fault. Skips where there is no card; run it on one
with

    python -m pytest portbench/tests -q -m gpu
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _sweep(*args):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "sweep.py"), *args],
        capture_output=True, text=True, timeout=900, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


# control -> (seeds, the number it has to fail)
CONTROLS = {
    "no-ba": (("301", "302", "303"), "ba_excess_px2"),
    "no-ratio": (("311", "312", "313"), "match_outlier_pct"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_control_fails_the_check(control):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seeds, number = CONTROLS[control]
    rows = _sweep("--workload", "temple6-sift.sparse", "--seeds", *seeds, "--control", control)
    assert len(rows) == len(seeds)
    for row in rows:
        assert row["passes"] is False, row
        assert row["numbers"][number] > row["limits"][number]["max"], row


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, a run
    exits with an error and prints no result line."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "temple6-sift.sparse", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
    )
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
