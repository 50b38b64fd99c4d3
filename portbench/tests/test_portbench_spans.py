"""The readers of the program's own spans and counters (portbench/spans.py
and the metrics that use it), on a made-up record of recent runs put in the
place of the program's recorder: the right values where the runs match the
window's timers, None on any mismatch and where the program is not loaded."""
import os
import sys
import types

import pytest

from portbench import spans
from portbench.harness import Bench

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NEW = ("score_s", "seed_s", "pnp_s", "triangulate_s", "ba_s", "lm_iterations", "pnp_attempts",
       "seed_basins", "first_set_extra_s")
MS = 1_000_000  # ns


def _run(k, set_ms):
    """One run's trace: a root "set", the six stages laid end to end, and
    under baseline a score span (300 ms) and a seed (500 ms) holding a pnp
    (40 ms), a triangulate (10 ms) and a ba (60 ms); the run's times are
    offset by `k` seconds."""
    t0 = k * 1000 * MS
    out = [dict(run=str(k), index=0, parent=-1, name="set", start_ns=t0, end_ns=t0 + set_ms * MS, attrs={})]

    def add(name, parent, a_ms, b_ms):
        out.append(dict(run=str(k), index=len(out), parent=parent, name=name,
                        start_ns=t0 + a_ms * MS, end_ns=t0 + b_ms * MS, attrs={}))
        return len(out) - 1

    t = 0
    for name, ms in zip(spans.STAGES, (50, 2, 900, 400, 0, 100)):
        i = add(name, 0, t, t + ms)
        if name == "baseline":
            add("baseline.score", i, t, t + 300)
            j = add("seed", i, t + 300, t + 800)
            add("pnp", j, t + 400, t + 440)
            add("triangulate", j, t + 440, t + 450)
            add("ba", j, t + 450, t + 510)
        t += ms
    counters = {"lm_iterations": 30, "pnp_attempts": 5, "seed_basins": 2}
    return {"run_id": str(k), "spans": out, "counters": counters}


def _timers(run):
    return {"t_" + s["name"]: spans.span_s(s) for s in run["spans"] if s["parent"] == 0}


@pytest.fixture
def program(monkeypatch):
    """The program's recorder replaced by a made-up one: a first run of 5 s,
    then two runs of 1.5 s, the window's."""
    first, runs = _run(0, 5000), [_run(1, 1500), _run(2, 1500)]
    fake = types.SimpleNamespace(recent_runs=lambda: [first] + runs, first_run=lambda: first)
    monkeypatch.setitem(sys.modules, spans.PROGRAM_RECORDER, fake)
    record = {"n_sets": 2, "timers": [_timers(r) for r in runs]}
    return record, runs


def _read(record):
    bench = Bench(ROOT)
    return {name: bench.reader(name)(record) for name in NEW}


def test_readers_on_matching_runs(program):
    record, runs = program
    assert spans.window_runs(record) == runs
    got = _read(record)
    want = {"score_s": 0.3, "seed_s": 0.5, "pnp_s": 0.04, "triangulate_s": 0.01, "ba_s": 0.06,
            "lm_iterations": 30.0, "pnp_attempts": 5.0, "seed_basins": 2.0, "first_set_extra_s": 3.5}
    assert got == pytest.approx(want)


def test_readers_with_a_failed_set(program):
    """A set that raised counts in n_sets and has no timers or trace."""
    record, runs = program
    record = dict(record, n_sets=4)
    got = _read(record)
    assert got["seed_s"] == pytest.approx(0.25) and got["pnp_attempts"] == 2.5
    assert got["first_set_extra_s"] == pytest.approx(3.5)


@pytest.mark.parametrize("fault", ["timer", "stage", "too_few"])
def test_none_on_a_mismatch(program, fault):
    record, runs = program
    if fault == "timer":
        record["timers"][1]["t_baseline"] += 1e-9
    elif fault == "stage":
        del record["timers"][0]["t_components"]
    else:
        record["timers"] = record["timers"] * 2
    assert spans.window_runs(record) is None
    assert all(v is None for v in _read(record).values())


def test_none_where_the_program_is_not_loaded(program, monkeypatch):
    record, _ = program
    monkeypatch.delitem(sys.modules, spans.PROGRAM_RECORDER)
    assert spans.window_runs(record) is None and spans.first_run() is None
    assert all(v is None for v in _read(record).values())


def test_none_where_the_program_keeps_no_runs(program, monkeypatch):
    """An older program: its recorder module is loaded but keeps no record."""
    record, _ = program
    monkeypatch.setitem(sys.modules, spans.PROGRAM_RECORDER, types.SimpleNamespace())
    assert all(v is None for v in _read(record).values())
