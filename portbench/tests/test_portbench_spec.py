"""BENCHMARK.json against the benchmark's contract, and the harness finding
every cell's files by name."""
import json
import os
import re
import shutil

import pytest

from portbench.harness import Bench

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return Bench(ROOT)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units(bench):
    spec = bench.spec
    assert set(spec) == KEYS["top"]
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    for group, kind in (("configs", "config"), ("workloads", "workload")):
        for entry in spec[group]:
            assert set(entry) == KEYS[kind], entry
            assert NAME.match(entry["name"]) and _line(entry["why"]), entry
    for entry in spec["configs"]:
        assert _line(entry["source"]) and all(NAME.match(k) for k in entry["reduced"])
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            assert set(m) - {"workloads"} == KEYS[kind], m
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in spec["per_layer"]:
        assert _line(m["layer"])
    names = [e["name"] for g in ("configs", "workloads", "end_to_end", "per_layer") for e in spec[g]]
    assert len(names) == len(set(names))
    assert all(_line(w) for w in spec["command"]) and len(json.dumps(spec)) < 64 * 1024


def test_bounds(bench):
    for m in bench.spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in bench.spec["end_to_end"]}


def test_every_cell_finds_its_files(bench):
    for cell in bench.spec["workloads"]:
        config, traffic = bench.config(cell), bench.traffic(cell)
        assert config["scene"]["n_views"] >= 3 and traffic["warmup_sets"] >= 0
        assert bench.limits(cell)
        for trace in (False, True):
            for m in bench.metrics(cell, trace):
                assert callable(bench.reader(m["name"]))
    files = {c["file"] for c in bench.spec["configs"]}
    assert len(files) == len(bench.spec["configs"])
    for c in bench.spec["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"] == f"portbench/configs/{c['name']}.json"


def test_per_layer_metrics_move_what_their_cells_report(bench):
    e2e = {m["name"]: m for m in bench.spec["end_to_end"]}
    cells = {c["name"] for c in bench.spec["workloads"]}
    for m in bench.spec["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in bench.spec["workloads"]:
        reported = {m["name"] for m in bench.metrics(cell, False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert bench.metrics(cell, True)


def test_readers_on_a_record(bench):
    record = {
        "setup_s": 30.0, "window_s": 40.0, "n_sets": 4, "peak_bytes": 2**30, "syncs": 400,
        "busy_s": 2.0, "knn2_s": 0.008, "knn2_least_s": 0.0012,
        "timers": [{"t_features": 0.5, "t_matching": 0.1, "t_baseline": 2.0, "t_incremental": 1.0,
                    "t_components": 0.1, "t_final_ba": 0.5}] * 4,
    }
    read = {m["name"]: bench.reader(m["name"])(record) for m in bench.spec["end_to_end"] + bench.spec["per_layer"]}
    assert read["set_s"] == 10.0 and read["setup_s"] == 30.0 and read["features_s"] == 0.5
    assert read["idle_pct"] == pytest.approx(95.0) and read["knn2_roofline"] == pytest.approx(15.0)
    assert read["host_syncs"] == 100 and read["peak_gib"] == 1.0
    assert bench.reader("idle_pct")({"window_s": 1.0}) is None


def test_new_cell_from_files_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as files,
    with their entries in BENCHMARK.json, make a new cell; no other file is
    edited."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec["configs"].append({"name": "throwaway-cfg", "source": "https://example.org/x",
                            "file": "portbench/configs/throwaway-cfg.json", "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "throwaway.cell", "config": "throwaway-cfg", "traffic": "throwaway-mix",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "throwaway_metric", "unit": "s", "better": "lower", "source": "program_span",
                              "layer": "Features (ops/sift.py)", "moves": "set_s", "workloads": ["throwaway.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    pb = tmp_path / "portbench"
    (pb / "configs" / "throwaway-cfg.json").write_text(json.dumps({"scene": {"n_views": 4, "ring_fraction": 0.1}}))
    (pb / "traffic" / "throwaway-mix.json").write_text(json.dumps({"warmup_sets": 0}))
    (pb / "limits" / "throwaway.cell.json").write_text(json.dumps({"limits": {"views_missing": {"max": 0}}}))
    (pb / "metrics" / "throwaway_metric.py").write_text("def read(record):\n    return 2.0 * record['n_sets']\n")
    b = Bench(str(tmp_path))
    cell = b.cell("throwaway.cell")
    assert b.config(cell)["scene"]["n_views"] == 4 and b.traffic(cell)["warmup_sets"] == 0
    assert b.limits(cell) == {"views_missing": {"max": 0}}
    per_layer = [m["name"] for m in b.metrics(cell, True)]
    assert "throwaway_metric" in per_layer
    assert b.reader("throwaway_metric")({"n_sets": 3}) == 6.0
    assert "throwaway_metric" not in [m["name"] for m in b.metrics(b.cell("temple6-sift.sparse"), True)]


def test_reference_imports_neither_the_program_nor_jax():
    """The yardstick in portbench/reference/ imports nothing of
    sfm_danpipeline_torch, sfm_danpipeline_tpu or JAX (top-level names
    compared whole)."""
    import ast
    import glob

    banned = {"sfm_danpipeline_torch", "sfm_danpipeline_tpu", "jax", "jaxlib", "flax"}
    for path in glob.glob(os.path.join(ROOT, "portbench", "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & banned, (path, names)


def test_device_trace_reduction_and_knn2_work():
    from portbench.reference.roofline import FP32_ACCURATE_FLOPS, knn2_work, least_seconds
    from portbench.reference.trace import DeviceTrace

    dt = DeviceTrace([("knn2_kernel<8>", 0, 10), ("gemm", 5, 20), ("knn2_norms_kernel", 30, 35), ("copy", 50, 60)])
    assert dt.busy_s(0, 100) == pytest.approx(35e-9)  # union 0-20, 30-35, 50-60
    assert dt.busy_s(15, 55) == pytest.approx(15e-9)
    assert dt.kernel_s("knn2") == (pytest.approx(15e-9), 2)
    assert dt.top_ops(1) == [["gemm", 15e-9]]
    idle = dict(dt.idle_by_span([("a", 0, 40), ("b", 40, 60), ("a", 60, 70)]))
    assert idle["a"] == pytest.approx((40 - 25 + 10) * 1e-9) and idle["b"] == pytest.approx(10e-9)
    flops, nbytes = knn2_work([3, 5, 7], D=128, K=8)  # pairs (0,1), (0,2), (1,2)
    assert flops == 2 * 128 * (15 + 21 + 35)
    assert nbytes == 3 * 8 * (4 * 128 + 1 + 8) + 2 * 4 * 3 + 3 * 4 * 3 * 8
    assert least_seconds(flops, nbytes) == max(flops / FP32_ACCURATE_FLOPS, nbytes / 3.35e12)
