"""Tracing / profiling helpers.

The reference's only instrumentation is one ad-hoc chrono timer around
matching (src/Sfm.cpp:509,575-583). Here (SURVEY.md §5): structured stage
timers feeding metrics.jsonl, plus an opt-in torch.profiler trace context
for kernel-level analysis (a Chrome / Perfetto trace file).
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Iterator, Optional


class StageTimer:
    """Accumulates wall-clock per named stage; serializable to metrics."""

    def __init__(self) -> None:
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

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

    def dump(self, path: str) -> None:
        with open(path, "a") as f:
            f.write(json.dumps({"stage_times": self.times,
                                "stage_counts": self.counts}) + "\n")


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace scope (no-op when log_dir is None): host and,
    where there is a card, device activity of the enclosed block, written
    to `<log_dir>/trace.json` on exit."""
    if not log_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
