"""Tracing / profiling: the port's one recorder.

The reference's only instrumentation is one ad-hoc chrono timer around
matching (src/Sfm.cpp:509,575-583). Here (SURVEY.md §5) `StageTimer` is
both the CLI's per-stage timer (`stage`, feeding metrics.jsonl) and the
trace of one `SfMPipeline.run`: nested spans and per-run counters.

A span records its run id, its own index and its parent's, its name,
`start_ns` and `end_ns` from `time.time_ns()` (the wall clock on which
torch.profiler's kineto events are stamped, so an idle gap of the card can
be put down to the span open on the host) and optional attributes. A span
ends when the host leaves its block: it never waits for the device, and an
attribute may only be a Python int, float, bool or str the host already
holds (a tensor raises TypeError, since reading one would synchronise).

`recording()` opens a trace for the calling thread; the module functions
`span`, `count` and `annotate` act on that thread's open trace and do
nothing outside one, so step functions record without a new parameter. A
trace that closes normally is kept in a bounded record of recent runs
(`recent_runs()`, `first_run()`); one whose block raises is dropped.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Deque, Dict, Iterator, List, Optional

ATTR_TYPES = (int, float, bool, str)
RECENT_RUNS = 256  # finished traces kept, besides the process's first

_open = threading.local()  # .trace: the calling thread's open StageTimer
_run_ids = itertools.count(1)
_lock = threading.Lock()
_recent: Deque[dict] = collections.deque(maxlen=RECENT_RUNS)
_first: List[dict] = []


def _check_attrs(attrs: Dict[str, object]) -> None:
    for k, v in attrs.items():
        if not isinstance(v, ATTR_TYPES):
            raise TypeError(
                f"span attribute {k!r} is a {type(v).__name__}; only host int, float, "
                "bool or str (reading a tensor would synchronise)"
            )


class StageTimer:
    """Accumulates wall-clock per named stage; serializable to metrics. Also
    one run's trace: spans (`span`) and counters (`count`)."""

    def __init__(self) -> None:
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.run_id = f"{os.getpid()}-{next(_run_ids)}"
        self.spans: List[dict] = []
        self.counters: Dict[str, int] = {}
        self._stack: List[int] = []  # indices of the open spans, innermost last
        self._trace = {"run_id": self.run_id, "spans": self.spans, "counters": self.counters}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def as_metrics(self, prefix: str = "t_") -> Dict[str, float]:
        return {f"{prefix}{k}": v for k, v in self.times.items()}

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[dict]:
        """A span around the block, a child of the innermost open one.
        Yields the span's record; `annotate` adds attributes to it."""
        _check_attrs(attrs)
        rec = {
            "run": self.run_id, "index": len(self.spans),
            "parent": self._stack[-1] if self._stack else -1,
            "name": name, "start_ns": 0, "end_ns": 0, "attrs": attrs,
        }
        self.spans.append(rec)
        self._stack.append(rec["index"])
        rec["start_ns"] = time.time_ns()
        try:
            yield rec
        finally:
            rec["end_ns"] = time.time_ns()
            self._stack.pop()

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def trace(self) -> dict:
        """The run's trace: {"run_id", "spans", "counters"} (JSON-ready),
        the same object on every call."""
        return self._trace


def span_seconds(rec: dict) -> float:
    """A closed span's duration (s)."""
    return (rec["end_ns"] - rec["start_ns"]) / 1e9


@contextlib.contextmanager
def recording() -> Iterator[StageTimer]:
    """Open a trace for the calling thread for the block's length. On a
    normal exit its trace joins the record of recent runs; if the block
    raises it is dropped. The thread's previous trace, if any, is restored."""
    prev = current()
    timer = StageTimer()
    _open.trace = timer
    try:
        yield timer
    finally:
        _open.trace = prev
    done = timer.trace()
    with _lock:
        if not _first:
            _first.append(done)
        _recent.append(done)


def current() -> Optional[StageTimer]:
    """The calling thread's open trace, or None outside a run."""
    return getattr(_open, "trace", None)


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[Optional[dict]]:
    """A span in the calling thread's open trace; yields None and records
    nothing outside a run."""
    timer = current()
    if timer is None:
        yield None
        return
    with timer.span(name, **attrs) as rec:
        yield rec


def count(name: str, n: int = 1) -> None:
    """Add `n` to a counter of the calling thread's open trace (nothing
    outside a run)."""
    timer = current()
    if timer is not None:
        timer.count(name, n)


def annotate(rec: Optional[dict], **attrs) -> None:
    """Add attributes to a span's record (nothing where `rec` is None)."""
    if rec is not None:
        _check_attrs(attrs)
        rec["attrs"].update(attrs)


def recent_runs() -> List[dict]:
    """The traces of the last RECENT_RUNS finished runs, oldest first."""
    with _lock:
        return list(_recent)


def first_run() -> Optional[dict]:
    """The trace of the process's first finished run."""
    with _lock:
        return _first[0] if _first else None
