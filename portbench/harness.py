"""Run one cell of the benchmark once: set-up, a measured window, the check
of what the window produced, and the result line.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell sits in a file of its own, found by the name that BENCHMARK.json
gives it:

- portbench/configs/<config>.json: the scene (views, arc, image size,
  intrinsics) and the PipelineConfig fields changed from the default
  ("pipeline");
- portbench/traffic/<traffic>.json: the warm-up: how many sets
  ("warmup_sets") of how many of the set's first views ("warmup_views",
  all of them where absent);
- portbench/metrics/<metric>.py: `read(record)` returns the metric's value
  from the run's record, or None where the run has nothing to read;
- portbench/limits/<cell>.json: the limit of each number the check compares,
  {"max": x} or {"min": x}, with where it comes from.

The window is a closed loop with one client: a set starts as soon as the one
before it has returned its outputs to the host. It opens when the first
timed set starts and closes when the set in flight at `seconds` finishes.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback
import warnings
from typing import Callable, Dict, List, Optional

BENCH_DIR = "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "sfm_danpipeline_tpu")
SYNC_WARNING = "synchroniz"  # in the text of torch's sync-debug warnings


class Bench:
    """BENCHMARK.json and the files it names, under a checkout's root."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def path(self, kind: str, name: str, ext: str) -> str:
        path = os.path.join(self.root, BENCH_DIR, kind, name + ext)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
        return path

    def _json(self, kind: str, name: str) -> dict:
        with open(self.path(kind, name, ".json")) as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        return self._json("configs", cell["config"])

    def traffic(self, cell: dict) -> dict:
        return self._json("traffic", cell["traffic"])

    def limits(self, cell: dict) -> Dict[str, Dict[str, float]]:
        return self._json("limits", cell["name"])["limits"]

    def metrics(self, cell: dict, trace: bool) -> List[dict]:
        """The metrics a run of `cell` reports: the end-to-end ones, or with
        `trace` the per-layer ones, each where its `workloads` (if any)
        list the cell."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}",
            self.path("metrics", metric, ".py"),
        )
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def _finite(x: float) -> Optional[float]:
    """A number for the result line: None where it is not finite."""
    return x if math.isfinite(x) else None


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unknown ({exc})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def host_spans(start_ns: int, end_ns: int, timers: Dict[str, float]):
    """What the host was doing during one set, as (name, start, end) in
    wall-clock ns, laid out from the program's stage timers: the SfM stages
    from the set's start in order, and the rest (construction, copies to the
    host) as "other"."""
    from portbench.program import SFM_TIMERS

    spans, t = [], start_ns
    for key in SFM_TIMERS:
        dt = int(timers[key] * 1e9)
        spans.append((key[2:], t, t + dt))
        t += dt
    spans.append(("other", t, end_ns))
    return spans


def run_cell(
    bench: Bench, name: str, seed: int, seconds: float, trace: bool,
    device: str = "cuda", t_start: Optional[float] = None,
):
    """One run of cell `name`. Returns (result, checks): the result line's
    object without its "checks", and {number: (value, limit)}."""
    t_start = time.time() if t_start is None else t_start
    cell = bench.cell(name)
    config, traffic, limits = bench.config(cell), bench.traffic(cell), bench.limits(cell)
    metrics = bench.metrics(cell, trace)
    readers = {m["name"]: bench.reader(m["name"]) for m in metrics}

    import torch

    from portbench import program
    from portbench.reference import judge, roofline, scene as scene_mod
    from portbench.reference.trace import DeviceTrace

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # Set-up: the card, the scene from the seed, the program's inputs, the
    # warm-up sets; each step's end is kept for set-up's split.
    marks = [("imports", time.time())]
    torch.zeros(1, device=device)
    sync()
    marks.append(("device_init", time.time()))
    scene = scene_mod.render(seed=seed, device=device, **config["scene"])
    images, intrinsics = program.inputs(scene.gray, scene.K)
    cfg = program.pipeline_config(config.get("pipeline", {}))
    warm = program.first_views(images, int(traffic.get("warmup_views") or scene.n_views))
    marks.append(("render", time.time()))
    for _ in range(int(traffic["warmup_sets"])):
        try:
            program.run_set(warm, intrinsics, cfg, device)
        except Exception:  # the timed sets will fail the same way, and say so
            traceback.print_exc()
    sync()
    marks.append(("warmup", time.time()))
    setup_s = marks[-1][1] - t_start
    setup_split = {name: t - prev for (name, t), prev in zip(marks, [t_start] + [t for _, t in marks])}
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # The window.
    prof = caught = None
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        torch.cuda.set_sync_debug_mode("warn")
    if trace:
        catcher = warnings.catch_warnings(record=True)
        caught = catcher.__enter__()
        warnings.simplefilter("always")
    sets = []
    t0 = time.time_ns()
    while True:
        a = time.time_ns()
        try:
            res = program.run_set(images, intrinsics, cfg, device)
        except Exception:  # a set that raises is a failed set; the window goes on
            traceback.print_exc()
            res = None
        b = time.time_ns()
        sets.append((a, b, res))
        if (b - t0) / 1e9 >= seconds:
            break
    window_s = (sets[-1][1] - t0) / 1e9
    if trace:
        catcher.__exit__(None, None, None)
    if prof is not None:
        torch.cuda.set_sync_debug_mode(0)
        prof.stop()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0

    n = len(sets)
    set_walls = [(a, b) for a, b, _ in sets]
    done = [r for _, _, r in sets if r is not None]
    record = {
        "setup_s": setup_s,
        "window_s": window_s,
        "n_sets": n,
        "timers": [r.timers for r in done],
        "peak_bytes": window_peak if cuda else None,
    }
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": max(setup_peak, window_peak),
    }
    breakdown = None
    if trace:
        record["syncs"] = sum(SYNC_WARNING in str(w.message) for w in caught) if cuda else None
    if prof is not None:
        dt = DeviceTrace.from_profiler(prof)
        work = [roofline.knn2_work(r.valid_rows, *r.descriptor_shape) for r in done]
        knn2_s, knn2_events = dt.kernel_s("knn2")
        record.update(
            busy_s=dt.busy_s(t0, sets[-1][1]),
            knn2_s=knn2_s if knn2_events else None,
            knn2_least_s=sum(roofline.least_seconds(f, b) for f, b in work),
        )
        device_info.update(busy_s=record["busy_s"], window_s=window_s)
        spans = [s for a, b, r in sets if r is not None for s in host_spans(a, b, r.timers)]
        breakdown = {"device_ops": dt.top_ops(10), "idle_gaps": dt.idle_by_span(spans, 10)}
        del prof, dt
    device_info["power"] = power_limit() if cuda else "none"

    # The check, once the window has closed and its peak has been read. A
    # set that raised has no numbers and fails every limit.
    per_set = judge.judge_each([r.rec for r in done], scene) + [{}] * (n - len(done))
    del sets, done
    failed, checks = judge.compare(per_set, limits)
    observed = {k: max(s[k] for s in per_set if k in s) for k in set().union(*per_set)}

    values = {}
    for m in metrics:
        value = readers[m["name"]](record)
        if value is not None:
            values[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {
        "correct": failed == 0,
        "attempted": n,
        "failed": failed,
        "metrics": values,
        "device": device_info,
        "sets_s": [(b - a) / 1e9 for a, b in set_walls],
        "setup_split_s": setup_split,
        "observed": {k: _finite(v) for k, v in sorted(observed.items())},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, checks


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bench = Bench(root)
    cell = bench.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); found {n}", file=sys.stderr)
        return 2
    result, checks = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    result["checks"] = {k: dict(value=_finite(v), **lim) for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        (side, limit), = lim.items()
        print(f"check {k} {v!r} {side} {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
