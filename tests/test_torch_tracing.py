"""The port's trace from inside `SfMPipeline.run` (utils/profiling.py): one
root span "set" per run, spans nested inside their parents' intervals, the
stage spans equal to the `t_*` timers, the step spans and counters under
them, nothing recorded for a run that raises or outside a run, no tensor
attributes, spans on the wall clock that torch.profiler stamps its events
with, and threads that record apart. The same run with local-window BA
and the rotation-averaging reinit switched on at V=6 holds the `reinit`
span inside `final_ba`, the `reinit_applied` counter and the `ba` spans
marked `local`.

The traced run is the port's V=6 courtyard run of tests/test_torch_slice.py
(240x320, 1,024 keypoints) on the CPU.
"""
import dataclasses

import pytest
import torch

from sfm_danpipeline_torch.config import BAConfig, FeatureConfig, PipelineConfig
from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline
from sfm_danpipeline_torch.utils import profiling
from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene
from torch_v6_reference import V6_MAX_KEYPOINTS, V6_SCENE

STAGES = ("features", "matching", "baseline", "incremental", "components", "final_ba")


@pytest.fixture(scope="module")
def v6():
    scene = make_courtyard_scene(**V6_SCENE)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = SfMPipeline(PipelineConfig(features=FeatureConfig(max_keypoints=V6_MAX_KEYPOINTS)), device="cpu").run(
            scene.images, scene.intrinsics
        )
    finally:
        torch.set_num_threads(threads)
    return res


def _by_name(trace, name):
    return [s for s in trace["spans"] if s["name"] == name]


def test_one_root_and_every_span_inside_its_parent(v6):
    spans = v6.trace["spans"]
    assert [s["name"] for s in spans if s["parent"] == -1] == ["set"] and spans[0]["name"] == "set"
    assert [s["index"] for s in spans] == list(range(len(spans)))
    for s in spans:
        assert s["run"] == v6.trace["run_id"]
        assert 0 < s["start_ns"] <= s["end_ns"]
        if s["parent"] >= 0:
            p = spans[s["parent"]]
            assert p["index"] < s["index"] and p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"], s


def test_stage_spans_are_the_timers(v6):
    root = v6.trace["spans"][0]
    stages = [s for s in v6.trace["spans"] if s["parent"] == root["index"]]
    assert [s["name"] for s in stages] == list(STAGES)
    for s in stages:
        assert v6.metrics["t_" + s["name"]] == profiling.span_seconds(s)


def test_score_and_seed_inside_baseline(v6):
    (baseline,) = _by_name(v6.trace, "baseline")
    (score,) = _by_name(v6.trace, "baseline.score")
    seeds = _by_name(v6.trace, "seed")
    assert score["parent"] == baseline["index"]
    assert seeds and seeds[0]["parent"] == baseline["index"]
    assert seeds[0]["attrs"]["pair_i"] == v6.metrics["baseline_pair_i"]
    assert seeds[0]["attrs"]["pair_j"] == v6.metrics["baseline_pair_j"]
    assert profiling.span_seconds(score) + profiling.span_seconds(seeds[0]) <= profiling.span_seconds(baseline)


def test_counters_and_their_spans(v6):
    c = v6.trace["counters"]
    assert c["pnp_attempts"] >= len(v6.registered_views) - 2
    assert c["seed_basins"] >= 1 and c["seed_basins_accepted"] >= 1 and c["seeds_validated"] >= 1
    assert c["lm_iterations"] >= c["ba_solves"] >= 1
    assert len(_by_name(v6.trace, "pnp")) == c["pnp_attempts"]
    assert sum(not s["attrs"]["ok"] for s in _by_name(v6.trace, "pnp")) == c.get("pnp_failed", 0)
    assert len(_by_name(v6.trace, "seed.basin")) == c["seed_basins"]
    ba = _by_name(v6.trace, "ba")
    assert len(ba) == c["ba_solves"] and sum(s["attrs"]["iterations"] for s in ba) == c["lm_iterations"]
    assert len(_by_name(v6.trace, "triangulate")) >= len(v6.registered_views) - 2


def test_finished_run_joins_the_recent_runs(v6):
    runs = profiling.recent_runs()
    assert any(r is v6.trace for r in runs)
    assert profiling.first_run() is not None and profiling.current() is None


def test_run_that_raises_records_nothing():
    scene = make_courtyard_scene(n_views=3, height=48, width=64, ring_fraction=0.05, seed=0)
    before = profiling.recent_runs()
    with pytest.raises(RuntimeError, match="baseline reconstruction failed"):
        SfMPipeline(PipelineConfig(), device="cpu").run(scene.images, scene.intrinsics)
    after = profiling.recent_runs()
    assert len(after) == len(before) and all(a is b for a, b in zip(after, before))
    assert profiling.current() is None


def test_tensor_attribute_raises_type_error():
    timer = profiling.StageTimer()
    with pytest.raises(TypeError, match="attribute 'n'"):
        with timer.span("x", n=torch.tensor(3)):
            pass
    assert timer.spans == [] and timer._stack == []
    with timer.span("y", n=3, ok=True, s="a", f=0.5) as rec:
        with pytest.raises(TypeError):
            profiling.annotate(rec, n=torch.ones(()))
    assert rec["attrs"] == {"n": 3, "ok": True, "s": "a", "f": 0.5}


def test_span_and_count_outside_a_run_do_nothing():
    before = profiling.recent_runs()
    assert profiling.current() is None
    with profiling.span("x", n=torch.tensor(1)) as rec:
        profiling.count("x")
        profiling.annotate(rec, n=2)
    assert rec is None and profiling.current() is None
    assert len(profiling.recent_runs()) == len(before)


def test_spans_share_the_profilers_clock():
    """A torch op run inside a span is stamped by torch.profiler (kineto)
    inside the span's interval: spans and device events can be laid over
    one another."""
    from torch.profiler import ProfilerActivity, profile

    timer = profiling.StageTimer()
    x = torch.ones(4096)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.span("op") as rec:
            torch.mul(x, 2.0)
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events() if e.name() == "aten::mul"]
    assert starts and all(rec["start_ns"] <= t <= rec["end_ns"] for t in starts), (starts, rec)


def test_threads_record_apart():
    """Each thread records into its own open trace: more threads than cores,
    a short switch interval, and every finished trace holds its own thread's
    spans and counts alone."""
    import sys
    import threading

    n_threads, n_runs = 12, 20
    done = {}

    def work(t):
        for k in range(n_runs):
            with profiling.recording() as timer:
                with profiling.span("outer", thread=t):
                    for _ in range(5):
                        with profiling.span("inner", thread=t):
                            profiling.count("c")
            done[(t, k)] = timer.trace()

    before = len(profiling.recent_runs())
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(done) == n_threads * n_runs
    for (t, _), trace in done.items():
        assert [s["attrs"]["thread"] for s in trace["spans"]] == [t] * 6
        assert [s["parent"] for s in trace["spans"]] == [-1, 0, 0, 0, 0, 0]
        assert trace["counters"] == {"c": 5}
    assert len(profiling.recent_runs()) == min(before + n_threads * n_runs, profiling.RECENT_RUNS)
    assert profiling.current() is None


@pytest.fixture(scope="module")
def v6_reinit():
    """The V=6 run again with local-window BA from the 4th view and the
    rotation-averaging reinit from 6 registered views, so both run."""
    scene = make_courtyard_scene(**V6_SCENE)
    ba = dataclasses.replace(BAConfig(), local_ba_min_views=4, rotavg_min_views=6)
    cfg = PipelineConfig(features=FeatureConfig(max_keypoints=V6_MAX_KEYPOINTS), ba=ba)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = SfMPipeline(cfg, device="cpu").run(scene.images, scene.intrinsics)
    finally:
        torch.set_num_threads(threads)
    assert len(res.registered_views) >= 6
    return res


def test_reinit_and_local_ba_spans(v6_reinit):
    spans = v6_reinit.trace["spans"]
    root = spans[0]
    assert [s["name"] for s in spans if s["parent"] == root["index"]] == list(STAGES)
    (final_ba,) = _by_name(v6_reinit.trace, "final_ba")
    (reinit,) = _by_name(v6_reinit.trace, "reinit")
    assert reinit["parent"] == final_ba["index"]
    assert reinit["attrs"]["n_registered"] == len(v6_reinit.registered_views)
    applied = reinit["attrs"]["applied"]
    assert isinstance(applied, bool)
    assert v6_reinit.trace["counters"]["reinit_applied"] == int(applied)
    assert v6_reinit.metrics.get("rotavg_applied", 0.0) == float(applied)
    # Where the reinit built a candidate, its three polishing solves sit
    # inside the span.
    inside = [s for s in _by_name(v6_reinit.trace, "ba") if s["parent"] == reinit["index"]]
    assert len(inside) in (0, 3)
    assert ("rotavg_applied" in v6_reinit.metrics) == (len(inside) == 3)
    local = [s for s in _by_name(v6_reinit.trace, "ba") if s["attrs"]["local"]]
    assert local
    stage_of = {s["index"]: s["name"] for s in spans if s["parent"] == root["index"]}
    for s in local:
        p = s
        while p["parent"] != root["index"]:
            p = spans[p["parent"]]
        assert stage_of[p["index"]] in ("baseline", "incremental", "components")


def test_reinit_and_stragglers_absent_below_their_thresholds(v6):
    assert not _by_name(v6.trace, "reinit") and "reinit_applied" not in v6.trace["counters"]
    assert not _by_name(v6.trace, "stragglers") and "straggler_views" not in v6.trace["counters"]
    assert not [s for s in _by_name(v6.trace, "ba") if s["attrs"]["local"]]
