"""The readers of the arc20 cell's spans and counters (`merge_s`,
`reinit_s`, `local_ba_s`, `reinit_applied`) on a made-up record of recent
runs put in the place of the program's recorder, as test_portbench_spans.py
does: the right values where the runs match the window's timers, None on a
mismatch and where the program is not loaded, and None for the reinit's
two where the runs hold no `reinit` span or counter (a program that does
not trace the reinit). The true reconstruction passes the cell's limits."""
import os
import sys
import types

import pytest

from portbench import spans
from portbench.harness import Bench
from portbench.reference import judge as J
from test_portbench_judge import _limits, truth  # noqa: F401  (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NEW = ("merge_s", "reinit_s", "local_ba_s", "reinit_applied")
MS = 1_000_000  # ns


def _run(k, applied, traced=True):
    """One run's trace: a root "set", the six stages laid end to end; under
    incremental a global ba (30 ms) and two local ones (20 ms each); under
    components a merge (200 ms) and a stragglers span (100 ms) holding a
    local ba (10 ms); under final_ba a reinit (900 ms) holding three ba
    (100 ms each), then the final ba (80 ms). `traced` False leaves out the
    reinit span and the new counters, as a program without them records."""
    t0 = k * 1000 * MS
    out = [dict(run=str(k), index=0, parent=-1, name="set", start_ns=t0, end_ns=t0 + 3000 * MS, attrs={})]

    def add(name, parent, a_ms, b_ms, **attrs):
        out.append(dict(run=str(k), index=len(out), parent=parent, name=name,
                        start_ns=t0 + a_ms * MS, end_ns=t0 + b_ms * MS, attrs=attrs))
        return len(out) - 1

    t = 0
    for name, ms in zip(spans.STAGES, (50, 2, 900, 400, 400, 1000)):
        i = add(name, 0, t, t + ms)
        if name == "incremental":
            add("ba", i, t, t + 30, local=False)
            add("ba", i, t + 30, t + 50, local=True)
            add("ba", i, t + 50, t + 70, local=True)
        elif name == "components":
            add("merge", i, t, t + 200)
            j = add("stragglers", i, t + 200, t + 300)
            add("ba", j, t + 200, t + 210, local=True)
        elif name == "final_ba":
            parent = add("reinit", i, t, t + 900, n_registered=20, applied=bool(applied)) if traced else i
            for n in range(3):
                add("ba", parent, t + 100 * n, t + 100 * (n + 1), local=False)
            add("ba", i, t + 900, t + 980, local=False)
        t += ms
    counters = {"lm_iterations": 30}
    if traced:
        counters.update(reinit_applied=int(applied), straggler_views=1)
    return {"run_id": str(k), "spans": out, "counters": counters}


def _timers(run):
    return {"t_" + s["name"]: spans.span_s(s) for s in run["spans"] if s["parent"] == 0}


def _program(monkeypatch, traced=True):
    first = _run(0, 1, traced)
    runs = [_run(1, 1, traced), _run(2, 0, traced)]
    fake = types.SimpleNamespace(recent_runs=lambda: [first] + runs, first_run=lambda: first)
    monkeypatch.setitem(sys.modules, spans.PROGRAM_RECORDER, fake)
    return {"n_sets": 2, "timers": [_timers(r) for r in runs]}


def _read(record):
    bench = Bench(ROOT)
    return {name: bench.reader(name)(record) for name in NEW}


def test_readers_on_matching_runs(monkeypatch):
    got = _read(_program(monkeypatch))
    want = {"merge_s": 0.2, "reinit_s": 0.9, "local_ba_s": 0.05, "reinit_applied": 0.5}
    assert got == pytest.approx(want)


def test_reinit_readers_none_on_a_program_without_the_span(monkeypatch):
    got = _read(_program(monkeypatch, traced=False))
    assert got["reinit_s"] is None and got["reinit_applied"] is None
    assert got["merge_s"] == pytest.approx(0.2) and got["local_ba_s"] == pytest.approx(0.05)


def test_none_on_a_mismatch(monkeypatch):
    record = _program(monkeypatch)
    record["timers"][1]["t_final_ba"] += 1e-9
    assert all(v is None for v in _read(record).values())


def test_none_where_the_program_is_not_loaded(monkeypatch):
    record = _program(monkeypatch)
    monkeypatch.delitem(sys.modules, spans.PROGRAM_RECORDER)
    assert all(v is None for v in _read(record).values())


def test_metrics_list_only_the_arc20_cell():
    bench = Bench(ROOT)
    by_name = {m["name"]: m for m in bench.spec["per_layer"]}
    for name in NEW:
        assert by_name[name]["workloads"] == ["arc20-sift.sparse"] and by_name[name]["moves"] == "set_s"
    cell = bench.cell("arc20-sift.sparse")
    assert cell["chips"] == 1 and cell["traffic"] == "sparse" and cell["config"] == "arc20-sift"
    assert set(NEW) <= {m["name"] for m in bench.metrics(cell, True)}
    assert not set(NEW) & {m["name"] for m in bench.metrics(bench.cell("temple6-sift.sparse"), True)}


def test_true_reconstruction_passes_the_arc20_limits(truth):  # noqa: F811
    scene, rec = truth
    numbers = J.judge(rec, scene)
    for name, limit in _limits("arc20-sift.sparse").items():
        assert J.within(numbers[name], limit), (name, numbers[name], limit)
