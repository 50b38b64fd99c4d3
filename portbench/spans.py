"""The program's own trace of the window's sets, for the per-layer metrics
that read spans and counters from inside `SfMPipeline.run`.

The program keeps the traces of its recent runs in memory
(sfm_danpipeline_torch/utils/profiling.py `recent_runs()`, `first_run()`).
This module finds that module among those already loaded and imports
nothing of the program: where the program is not loaded, or keeps no such
record, every reader gets None.

A trace is {"run_id", "spans", "counters"}; a span is {"run", "index",
"parent", "name", "start_ns", "end_ns", "attrs"}, on the wall clock of
`time.time_ns()`.
"""
from __future__ import annotations

import sys
from typing import List, Optional

PROGRAM_RECORDER = "sfm_danpipeline_torch.utils.profiling"
# The stage spans under the root span "set", as the program's timers name them.
STAGES = ("features", "matching", "baseline", "incremental", "components", "final_ba")


def _recorder():
    return sys.modules.get(PROGRAM_RECORDER)


def span_s(span: dict) -> float:
    """A span's duration (s), computed as the program computes its timers."""
    return (span["end_ns"] - span["start_ns"]) / 1e9


def window_runs(record: dict) -> Optional[List[dict]]:
    """The traces of the window's completed sets: the program's last
    len(record["timers"]) finished runs, where each run's six stage spans
    equal that set's timers exactly; None otherwise (no program loaded, no
    record of runs, too few runs, or any mismatch)."""
    recent = getattr(_recorder(), "recent_runs", None)
    n = len(record["timers"])
    if recent is None or n == 0:
        return None
    runs = recent()[-n:]
    if len(runs) < n:
        return None
    for run, timers in zip(runs, record["timers"]):
        stages = {s["name"]: s for s in run["spans"] if s["parent"] == 0}
        if set(stages) != set(STAGES):
            return None
        if any(span_s(stages[name]) != timers.get("t_" + name) for name in STAGES):
            return None
    return runs


def first_run() -> Optional[dict]:
    """The trace of the program's first run in this process, or None."""
    first = getattr(_recorder(), "first_run", None)
    return first() if first is not None else None


def span_per_set(record: dict, name: str) -> Optional[float]:
    """Seconds in the spans named `name` over the window's sets, divided by
    their number; None where the window's runs cannot be read."""
    runs = window_runs(record)
    if runs is None:
        return None
    return sum(span_s(s) for run in runs for s in run["spans"] if s["name"] == name) / record["n_sets"]


def count_per_set(record: dict, name: str) -> Optional[float]:
    """The counter `name` summed over the window's sets, divided by their
    number; None where the window's runs cannot be read."""
    runs = window_runs(record)
    if runs is None:
        return None
    return sum(run["counters"].get(name, 0) for run in runs) / record["n_sets"]
