"""Reduce a torch.profiler device trace to the benchmark's numbers.

The busy time is the union of the intervals in which a kernel, copy or
memset ran on the card, as `profile_runs` in tools/torch_stage_probe.py
computes it (its `_merged_length`, copied here as `merged`, which keeps the
union so that any host interval can be laid over it), taken over the whole
traced window. Events are read from the profiler's raw kineto results, whose times
are wall-clock nanoseconds, so host intervals (`time.time_ns()`) can be laid
over them.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Sequence, Tuple


def merged(intervals) -> List[Tuple[int, int]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclasses.dataclass
class DeviceTrace:
    events: List[Tuple[str, int, int]]  # (name, start ns, end ns) on the card

    def __post_init__(self):
        self._union = merged((a, b) for _, a, b in self.events)
        self._starts = [a for a, _ in self._union]

    @classmethod
    def from_profiler(cls, prof) -> "DeviceTrace":
        from torch.autograd import DeviceType

        events = [
            (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
        ]
        return cls(events)

    def busy_s(self, start_ns: int, end_ns: int) -> float:
        """Seconds of [start_ns, end_ns) in which something ran on the card."""
        i = max(bisect.bisect_right(self._starts, start_ns) - 1, 0)
        total = 0
        for a, b in self._union[i:]:
            if a >= end_ns:
                break
            total += max(0, min(b, end_ns) - max(a, start_ns))
        return total / 1e9

    def kernel_s(self, fragment: str) -> Tuple[float, int]:
        """Summed device time and count of the events whose name holds
        `fragment`."""
        hits = [b - a for name, a, b in self.events if fragment in name]
        return sum(hits) / 1e9, len(hits)

    def top_ops(self, n: int = 10) -> List[List]:
        """The device operations that took the most time: [name, seconds]."""
        by_name: Dict[str, int] = {}
        for name, a, b in self.events:
            by_name[name] = by_name.get(name, 0) + (b - a)
        rows = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:n]
        return [[name[:120], ns / 1e9] for name, ns in rows]

    def idle_by_span(self, spans: Sequence[Tuple[str, int, int]], n: int = 10) -> List[List]:
        """Idle seconds of the card inside each named host span, summed by
        name: [name, seconds], the largest first."""
        idle: Dict[str, float] = {}
        for name, a, b in spans:
            if b > a:
                idle[name] = idle.get(name, 0.0) + (b - a) / 1e9 - self.busy_s(a, b)
        return [[k, v] for k, v in sorted(idle.items(), key=lambda kv: kv[1], reverse=True)[:n]]
