"""The reader of `pnp_replays` on made-up records of recent runs put
in the place of the program's recorder: the counter per set where the
window's runs carry it (a run without it counts 0), None where none does (a
program that does not count it) and where the runs cannot be read."""
import os
import sys
import types

import pytest

from portbench import spans
from portbench.harness import Bench

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run(k, counters):
    """One run's trace: a root "set" and the six stages laid end to end."""
    t0 = k * 10**9
    out = [dict(run=str(k), index=0, parent=-1, name="set", start_ns=t0, end_ns=t0 + 10**8, attrs={})]
    for i, name in enumerate(spans.STAGES):
        out.append(dict(run=str(k), index=i + 1, parent=0, name=name,
                        start_ns=t0 + i * 10**7, end_ns=t0 + (i + 1) * 10**7, attrs={}))
    return {"run_id": str(k), "spans": out, "counters": counters}


def _record(monkeypatch, runs):
    fake = types.SimpleNamespace(recent_runs=lambda: runs, first_run=lambda: runs[0])
    monkeypatch.setitem(sys.modules, spans.PROGRAM_RECORDER, fake)
    timers = [{"t_" + s["name"]: spans.span_s(s) for s in r["spans"] if s["parent"] == 0} for r in runs]
    return {"n_sets": len(runs), "timers": timers}


@pytest.mark.parametrize("counters, want", [
    ([{"pnp_graph_replays": 27}, {"pnp_graph_replays": 27}], 27.0),
    ([{"pnp_graph_replays": 26}, {"pnp_graph_replays": 29}], 27.5),
    ([{"pnp_graph_replays": 4}, {"seed_basins": 1}], 2.0),
    ([{"seed_basins": 1}, {"seed_basins": 1}], None),
])
def test_pnp_replays_per_set(monkeypatch, counters, want):
    record = _record(monkeypatch, [_run(k, c) for k, c in enumerate(counters)])
    assert Bench(ROOT).reader("pnp_replays")(record) == want


def test_pnp_replays_none_without_the_program(monkeypatch):
    monkeypatch.delitem(sys.modules, spans.PROGRAM_RECORDER, raising=False)
    record = {"n_sets": 1, "timers": [{"t_" + s: 0.1 for s in spans.STAGES}]}
    assert Bench(ROOT).reader("pnp_replays")(record) is None
